"""container.crc_ms: host-clock milliseconds a file read spends in the
header parse and the CRC-16 of header and data (container/basis.py
`read_header` and `check_file_checksum`), over every file read in the
window."""

SPANS = {
    "container.crc": [
        "basisu_rs_tpu_torch.container.basis:read_header",
        "basisu_rs_tpu_torch.container.basis:check_file_checksum",
    ]
}


def read(record):
    times = record.spans.get("container.crc")
    return sum(times) / record.calls * 1e3 if times else None
