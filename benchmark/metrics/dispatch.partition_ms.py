"""dispatch.partition_ms: the mean host-clock time a request of the
mode partition (ops/dispatch.py `partition`: the modes, the argsort, the
bincount and the read of the 20 counts, the call's one host sync)."""

SPANS = {"dispatch.partition": ["basisu_rs_tpu_torch.ops.dispatch:partition"]}


def read(record):
    times = record.spans.get("dispatch.partition")
    return sum(times) / record.calls * 1e3 if times else None
