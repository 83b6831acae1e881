"""Train and Data ingest: host milliseconds a step spends in ``next()`` of
the shard's ``iter_torch_batches``, over the window's steps."""


def read(record):
    return record.get("ingest_ms_per_step")
