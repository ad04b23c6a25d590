"""frontend.ns_per_block: host-clock nanoseconds a block of the ETC1S
front-end (container/basis.py `make_etc1s_decoder`, the codebooks and
Huffman tables, and `etc1s_index_streams`, the slices' index streams),
over every file read in the window."""

SPANS = {
    "frontend": [
        "basisu_rs_tpu_torch.container.basis:make_etc1s_decoder",
        "basisu_rs_tpu_torch.container.basis:etc1s_index_streams",
    ]
}


def read(record):
    times = record.spans.get("frontend")
    return sum(times) / record.blocks * 1e9 if times and record.blocks else None
