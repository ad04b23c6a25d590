"""PyTorch port: the tables loader, the device tables and the generated
CUDA header (basisu_rs_tpu_torch/tables.py, gen_header.py)."""

import subprocess
import sys
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
import torch

import basisu_rs_tpu.tables as jt
from basisu_rs_tpu_torch import gen_header
from basisu_rs_tpu_torch.tables import FAMILIES, MODES, device_tables, kernel_tables

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    # the test process already holds jax (conftest), so check a fresh one
    code = (
        "import sys, basisu_rs_tpu_torch\n"
        "import basisu_rs_tpu_torch.ops.kernels, basisu_rs_tpu_torch.ops.dispatch\n"
        "import basisu_rs_tpu_torch.gen_header\n"
        "print('jax' in sys.modules, "
        "any(k == 'basisu_rs_tpu' or k.startswith('basisu_rs_tpu.') for k in sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


def test_header_matches_generator():
    assert gen_header.HEADER.read_text() == gen_header.render(), (
        "csrc/uastc_tables.cuh is stale: run python -m basisu_rs_tpu_torch.gen_header"
    )


def test_loader_shares_the_reference_tables():
    assert [astuple(m) for m in MODES] == [astuple(m) for m in jt.MODES]
    assert [m.field_offsets for m in MODES] == [m.field_offsets for m in jt.MODES]
    np.testing.assert_array_equal(kernel_tables()[0]["MODE_LUT"], jt.np_tables()["MODE_LUT"])


@pytest.mark.parametrize("fam", FAMILIES)
def test_flat_family_tables_match_reference(fam):
    arrays, layout = kernel_tables()
    ref = jt._families()[fam]
    base = layout.fam_base[fam]
    rows = slice(base, base + ref.count)
    np.testing.assert_array_equal(arrays["FAM_ANCHORS_PACKED"][rows], ref.anchors_packed)
    np.testing.assert_array_equal(
        arrays["FAM_ANCHORS_BEFORE_PACKED"][rows], jt.fam_anchors_before_packed(fam)
    )
    np.testing.assert_array_equal(arrays["FAM_BC7_INDEX"][rows], ref.bc7_index)
    np.testing.assert_array_equal(arrays["FAM_BC7_PAT_PACKED"][rows], ref.bc7_pat_packed)
    np.testing.assert_array_equal(arrays["FAM_PERM_PACKED"][rows], ref.perm_packed)
    np.testing.assert_array_equal(
        arrays["FAM_BC7_WEIGHT_PRESHIFT_PACKED"][rows], jt.fam_bc7_weight_preshift_packed(fam)
    )
    for (name, wb), b in layout.inv_relpos_base.items():
        if name == fam:
            np.testing.assert_array_equal(
                arrays["FAM_BC7_INV_RELPOS_PACKED"][b : b + ref.count],
                jt.fam_bc7_inv_relpos_packed(fam, wb),
            )


def test_unquant_lut_and_optimal_tables_match_reference():
    from basisu_rs_tpu.tables.bise import unquant_lut

    arrays, layout = kernel_tables()
    for r, base in layout.unquant_base.items():
        lut = unquant_lut(r)
        np.testing.assert_array_equal(arrays["UNQUANT_LUT"][base : base + len(lut)], lut)
    np.testing.assert_array_equal(arrays["BC7_MODE_5_OPTIMAL_PACKED"], jt.bc7_mode_5_optimal_packed())
    np.testing.assert_array_equal(arrays["BC7_MODE_6_OPTIMAL_PACKED"], jt.bc7_mode_6_optimal_packed())


def test_device_tables_equal_kernel_tables():
    arrays, _ = kernel_tables()
    tabs = device_tables("cpu")
    assert set(tabs) == set(arrays)
    for name, a in arrays.items():
        assert tabs[name].device.type == "cpu"
        np.testing.assert_array_equal(tabs[name].numpy().astype(np.int64), a.astype(np.int64))
    assert tabs["MODE_LUT"].dtype == torch.uint8
