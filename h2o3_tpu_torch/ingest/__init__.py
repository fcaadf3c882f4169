"""Ingest of the port: ``parse.py`` (``parse_setup``, ``parse``,
``import_file``), ``chunk.py`` (the typed chunk encode and merge),
``stream.py`` (per-chunk copies to the card), ``compress.py`` (gzip and
zstd), ``formats.py`` (ARFF, SVMLight, Parquet, ORC, Avro, xlsx),
``persist_uri.py`` (URIs) and ``sql.py`` (``import_sql_table``)."""
