"""PyTorch port: the end-to-end A/B tool (basisu_rs_tpu_torch/tools/e2e_ab.py)
on the CPU.  Its timing needs a card; here its loader and its result
flattening are held: a checkout imported under its own module name is a
second copy of the package (own modules, own launch counters) that
computes what the package computes, and the flattening finds every tensor
of each kind of workload result."""

import sys
from pathlib import Path

import numpy as np
import torch

import basisu_rs_tpu_torch as tb
from basisu_rs_tpu_torch.api import Image
from basisu_rs_tpu_torch.models.pipeline import FileResult
from basisu_rs_tpu_torch.tools import e2e_ab

ROOT = Path(__file__).resolve().parents[1]


def test_checkout_loads_under_its_own_name(golden):
    alias = "e2e_ab_test_copy"
    try:
        mods = e2e_ab.load_package(ROOT, alias)
        copy = mods[""]
        assert copy is not tb and copy.__name__ == alias
        assert mods["ops.etc1s"] is sys.modules[f"{alias}.ops.etc1s"]
        assert mods["ops.etc1s"].etc1s_kernel("rgba") is not tb.ops.etc1s.etc1s_kernel("rgba")
        blocks = golden["bc7_in"]
        out, err = copy.transcode_uastc_blocks(blocks, "bc7", device="cpu")
        ref, ref_err = tb.transcode_uastc_blocks(blocks, "bc7", device="cpu")
        assert torch.equal(out, ref) and torch.equal(err, ref_err)
        np.testing.assert_array_equal(out.numpy(), golden["bc7_out"].view(np.uint8).reshape(len(blocks), 16))
    finally:
        for name in [k for k in sys.modules if k == alias or k.startswith(alias + ".")]:
            del sys.modules[name]


def test_tensors_flattens_every_result_kind():
    a, b, c = torch.arange(3), torch.zeros(2, 2), np.ones(4, np.uint8)
    img = Image(w=4, h=4, stride=16, data=b)
    assert [t.shape for t in e2e_ab._tensors((a, torch.ones(3, dtype=torch.bool)))] == [(3,), (3,)]
    flat = e2e_ab._tensors(("header", [img, img]))  # read_to_rgba: (Header, images)
    assert len(flat) == 2 and all(t is b for t in flat)
    assert torch.equal(e2e_ab._tensors([c])[0], torch.from_numpy(c))  # a corpus' numpy slices
    assert e2e_ab._tensors([FileResult("p", [img], 16)]) == [b]  # a pipeline's file results
    assert e2e_ab._tensors("no tensor") == []
