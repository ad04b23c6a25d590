"""PyTorch port: its own copy of the tables (basisu_rs_tpu_torch/tables/),
the flat device tables and the generated CUDA header (gen_header.py)."""

import subprocess
import sys
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
import torch

import basisu_rs_tpu.tables as jt
import basisu_rs_tpu.tables.generated_tables as jg
import basisu_rs_tpu_torch.tables as tt
import basisu_rs_tpu_torch.tables.generated_tables as tg
from basisu_rs_tpu.tables.bise import unquant_lut as j_unquant_lut
from basisu_rs_tpu_torch import gen_header
from basisu_rs_tpu_torch.tables import FAMILIES, device_tables, kernel_tables

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    # the test process already holds jax (conftest), so check a fresh one:
    # import every module of the port and chip_smoke and load its native
    # host libraries, then look at what got loaded and from where
    code = (
        "import pkgutil, sys\n"
        "from pathlib import Path\n"
        "import basisu_rs_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(basisu_rs_tpu_torch.__path__, 'basisu_rs_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from basisu_rs_tpu_torch.container import crc, etc1s_frontend\n"
        "crc._lib(), etc1s_frontend._lib()  # the host C++ libraries, built and bound\n"
        "jax_pkg = Path('basisu_rs_tpu').resolve()\n"
        "under = sorted(k for k, m in list(sys.modules.items())\n"
        "               if getattr(m, '__file__', None) and jax_pkg in Path(m.__file__).resolve().parents)\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')) or 'no-jax')\n"
        "print(under or 'none-under-jax-package')\n"
        "print(len([k for k in sys.modules if k.startswith('basisu_rs_tpu_torch.')]))\n"
        "print(all(k in sys.modules for k in ('basisu_rs_tpu_torch.__main__',\n"
        "                                     'basisu_rs_tpu_torch.tools.ablate_bc7',\n"
        "                                     'basisu_rs_tpu_torch.parallel.mesh',\n"
        "                                     'basisu_rs_tpu_torch.parallel.multihost')))\n"
        "import torch.distributed as dist\n"
        "from basisu_rs_tpu_torch.parallel import __all__ as names\n"
        "print(not dist.is_initialized(), ','.join(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    # importing the CLI and the T1 tool runs nothing: the four lines above are all the output
    jax_mods, under, n_port, entry_points, parallel = res.stdout.splitlines()
    assert jax_mods == "no-jax"
    assert under == "none-under-jax-package"
    assert int(n_port) >= 42  # every module of the port was imported
    assert entry_points == "True"
    # importing the parallel package starts no process group; its names are the JAX package's
    import basisu_rs_tpu.parallel as jax_parallel

    assert parallel == f"True {','.join(jax_parallel.__all__)}"


def test_header_matches_generator():
    assert gen_header.HEADER.read_text() == gen_header.render(), (
        "csrc/uastc_tables.cuh is stale: run python -m basisu_rs_tpu_torch.gen_header"
    )


# (name, port value, JAX package value): every table of the port's copy
_GENERATED = sorted(k for k in vars(jg) if k.isupper())
_FAM_FIELDS = [
    "count", "nsub", "pat_texels", "pat_packed", "anchors", "anchors_packed", "astc_index10",
    "bc7_index", "bc7_pat_texels", "bc7_pat_packed", "bc7_anchors", "bc7_anchors_packed",
    "perm", "perm_packed",
]
_FAM_PACKERS = [
    "fam_anchors_before", "fam_anchors_before_packed", "fam_bc7_anchors_before",
    "fam_bc7_weight_preshift_packed",
]
CASES = {f"generated.{k}": (lambda k=k: getattr(tg, k), lambda k=k: getattr(jg, k)) for k in _GENERATED}
CASES.update({
    "MODES": (lambda: [astuple(m) + (m.field_offsets,) for m in tt.MODES],
              lambda: [astuple(m) + (m.field_offsets,) for m in jt.MODES]),
    "BC7_MODES": (lambda: [astuple(m) for m in tt.BC7_MODES], lambda: [astuple(m) for m in jt.BC7_MODES]),
    "BISE_RANGES": (lambda: [astuple(r) for r in tt.BISE_RANGES], lambda: [astuple(r) for r in jt.BISE_RANGES]),
    "scalars": (lambda: (tt.LA, tt.RGB, tt.RGBA, tt.MODE8_RGBA_OFFSET, tt.MODE8_ETC1_FLAGS_OFFSET,
                         tt.UASTC_BLOCK_SIZE),
                lambda: (jt.LA, jt.RGB, jt.RGBA, jt.MODE8_RGBA_OFFSET, jt.MODE8_ETC1_FLAGS_OFFSET,
                         jt.UASTC_BLOCK_SIZE)),
    "etc_bias_deltas": (tt.etc_bias_deltas, jt.etc_bias_deltas),
    "bc7_mode_5_optimal_packed": (tt.bc7_mode_5_optimal_packed, jt.bc7_mode_5_optimal_packed),
    "bc7_mode_6_optimal_packed": (tt.bc7_mode_6_optimal_packed, jt.bc7_mode_6_optimal_packed),
})
CASES.update({f"np_tables.{k}": (lambda k=k: tt.np_tables()[k], lambda k=k: jt.np_tables()[k])
              for k in tt.np_tables()})
CASES.update({f"family.{f}.{fld}": (lambda f=f, fld=fld: getattr(tt._families()[f], fld),
                                     lambda f=f, fld=fld: getattr(jt._families()[f], fld))
              for f in FAMILIES for fld in _FAM_FIELDS})
CASES.update({f"{fn}({f})": (lambda f=f, fn=fn: getattr(tt, fn)(f), lambda f=f, fn=fn: getattr(jt, fn)(f))
              for f in FAMILIES for fn in _FAM_PACKERS})
CASES.update({f"fam_bc7_inv_relpos_packed({f},{wb})": (lambda f=f, wb=wb: tt.fam_bc7_inv_relpos_packed(f, wb),
                                                        lambda f=f, wb=wb: jt.fam_bc7_inv_relpos_packed(f, wb))
              for f, wb in kernel_tables()[1].inv_relpos_base})
CASES.update({f"unquant_lut({r})": (lambda r=r: tt.unquant_lut(r), lambda r=r: j_unquant_lut(r))
              for r, rng in enumerate(jt.BISE_RANGES) if rng.trits or rng.quints})


@pytest.mark.parametrize("name", sorted(CASES))
def test_own_copy_equals_reference(name):
    port, ref = (fn() for fn in CASES[name])
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray) and port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)
    else:
        assert port == ref


def test_get_family_matches_reference():
    for tm, jm in zip(tt.MODES, jt.MODES):
        tf, jf = tt.get_family(tm), jt.get_family(jm)
        assert (tf is None and jf is None) or tf.name == jf.name


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
    np.testing.assert_array_equal(arrays["FAM_BC7_ANCHORS_PACKED"][rows], ref.bc7_anchors_packed)
    np.testing.assert_array_equal(arrays["FAM_PERM_PACKED"][rows], ref.perm_packed)
    np.testing.assert_array_equal(
        arrays["FAM_BC7_WEIGHT_PRESHIFT_PACKED"][rows], jt.fam_bc7_weight_preshift_packed(fam)
    )
    np.testing.assert_array_equal(arrays["FAM_PAT_PACKED"][rows], ref.pat_packed)
    np.testing.assert_array_equal(arrays["FAM_ASTC_INDEX10"][rows], ref.astc_index10)
    for (name, wb), b in layout.inv_relpos_base.items():
        if name == fam:
            np.testing.assert_array_equal(
                arrays["FAM_BC7_INV_RELPOS_PACKED"][b : b + ref.count],
                jt.fam_bc7_inv_relpos_packed(fam, wb),
            )


def test_unquant_lut_and_optimal_tables_match_reference():
    arrays, layout = kernel_tables()
    for r, base in layout.unquant_base.items():
        lut = j_unquant_lut(r)
        np.testing.assert_array_equal(arrays["UNQUANT_LUT"][base : base + len(lut)], lut)
    np.testing.assert_array_equal(arrays["BC7_MODE_5_OPTIMAL_PACKED"], jt.bc7_mode_5_optimal_packed())
    np.testing.assert_array_equal(arrays["BC7_MODE_6_OPTIMAL_PACKED"], jt.bc7_mode_6_optimal_packed())


def test_astc_tables_match_reference():
    arrays, _ = kernel_tables()
    for k in ("MODE_LUT", "ASTC_QUINT_ENCODE", "ASTC_TRIT_ENCODE"):
        np.testing.assert_array_equal(arrays[k], jt.np_tables()[k])
    assert len(arrays["ASTC_QUINT_ENCODE"]) == 125 and len(arrays["ASTC_TRIT_ENCODE"]) == 243
    header = gen_header.HEADER.read_text()
    for cfg in tt.MODES:
        mode13 = int(jt.np_tables()["UASTC_TO_ASTC_BLOCK_MODE_13"][cfg.id])
        traits = header.split(f"struct Mode<{cfg.id}> {{")[1].split("};")[0]
        assert f"static constexpr int astc_block_mode = {mode13};" in traits


def test_etc_packed_tables_match_reference():
    # the packed forms the CUDA header and the plain version read, unpacked
    # and held against the JAX package's arrays and its own packing
    import jax.numpy as jnp

    from basisu_rs_tpu.ops.etc import _packed_bias_deltas

    arrays, _ = kernel_tables()
    ref = jt.np_tables()
    w = arrays["ETC1_MOD_PACKED"].astype(np.int64)
    small, big = w & 255, w >> 8
    np.testing.assert_array_equal(np.stack([-big, -small, small, big], 1), ref["ETC1_MODIFIERS"])
    np.testing.assert_array_equal(arrays["ETC_BIAS_PACKED"].astype(np.int64),
                                  np.asarray(_packed_bias_deltas(jnp.arange(32))))
    bias = arrays["ETC_BIAS_PACKED"].astype(np.int64)
    for sb in range(2):
        for c in range(3):
            np.testing.assert_array_equal(((bias >> (2 * (3 * sb + c))) & 3) - 2, ref["ETC_BIAS_DELTAS"][:, sb, c])
    eac = arrays["EAC_MOD_PACKED"].astype(np.int64).reshape(16, 2)
    mods = np.stack([(eac[:, j >> 2] >> (8 * (j & 3))) & 255 for j in range(8)], 1) - 15
    np.testing.assert_array_equal(mods, ref["ETC2_ALPHA_MODIFIERS"])
    assert arrays["EAC_FRACTION_BITS"].dtype == np.uint32
    np.testing.assert_array_equal(arrays["EAC_FRACTION_BITS"], ref["ETC2_ALPHA_FRACTION"].view(np.uint32))
    header = gen_header.HEADER.read_text()
    assert "constexpr int MODE8_RGBA_OFFSET = 5, MODE8_ETC1_FLAGS_OFFSET = 37;" in header
    for cfg in jt.MODES:
        traits = header.split(f"struct Mode<{cfg.id}> {{")[1].split("};")[0]
        assert f"static constexpr int ofs_trans_flags = {cfg.field_offsets['trans_flags']};" in traits


def test_device_tables_equal_kernel_tables():
    arrays, _ = kernel_tables()
    tabs = device_tables("cpu")
    assert set(tabs) == set(arrays)
    for name, a in arrays.items():
        assert tabs[name].device.type == "cpu"
        np.testing.assert_array_equal(tabs[name].numpy().astype(np.int64), a.astype(np.int64))
    assert tabs["MODE_LUT"].dtype == torch.uint8
