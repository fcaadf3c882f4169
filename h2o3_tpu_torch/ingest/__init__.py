"""CSV ingest of the port (``parse.py``: ``parse_setup``, ``parse``,
``import_file``; ``chunk.py``: the typed chunk encode and merge)."""
