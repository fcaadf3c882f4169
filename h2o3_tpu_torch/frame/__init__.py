from h2o3_tpu_torch.frame.frame import Frame  # noqa: F401
from h2o3_tpu_torch.frame.vec import Vec  # noqa: F401
