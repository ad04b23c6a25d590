"""PyTorch port: the corpus transcoders (basisu_rs_tpu_torch/models/
transcoder.py) against the JAX package's, on the CPU.

UASTC: the golden blocks through UastcTranscoder (sync and async) and
CorpusTranscoder, against the golden outputs, with gather() dtypes and
shapes equal to the JAX transcoder's (run on the 32 golden blocks of one
mode, so JAX compiles one kernel a target).  ETC1S: the multi-file batcher
against per-file runs and against the JAX package's, zero-slice files, the
alpha-mismatch messages and the codebook-budget split.  Every comparison
is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import basisu_rs_tpu.models as jm
import basisu_rs_tpu.models.transcoder as jtmod
import basisu_rs_tpu_torch.models.transcoder as tmod
from basisu_rs_tpu.api import BasisError as JaxBasisError
from basisu_rs_tpu.tables import np_tables
from basisu_rs_tpu_torch.api import BasisError
from basisu_rs_tpu_torch.models import (
    CorpusTranscoder,
    Etc1sCorpusTranscoder,
    Etc1sFileWork,
    Etc1sMultiCorpusTranscoder,
    UastcTranscoder,
)
from basisu_rs_tpu_torch.ops import etc1s

TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")


def _golden_out(golden, target):
    return golden[f"{target}_out"]


@pytest.mark.parametrize("target", TARGETS)
def test_uastc_transcoder_matches_golden_and_jax_dtypes(golden, target):
    tr = UastcTranscoder(target, device="cpu")
    out, err = tr.transcode(golden["bc7_in"])
    np.testing.assert_array_equal(out, _golden_out(golden, target))
    assert not err.any() and err.dtype == np.bool_
    # the JAX transcoder's gather on one mode's golden blocks: same dtypes and row shapes
    lut = np_tables()["MODE_LUT"]
    one = golden["bc7_in"][lut[golden["bc7_in"][:, 0] & 0x7F] == 8]
    j_out, j_err = jm.UastcTranscoder(target).transcode(one)
    p_out, p_err = tr.transcode(one)
    assert (p_out.dtype, p_out.shape, p_err.dtype, p_err.shape) == (j_out.dtype, j_out.shape, j_err.dtype, j_err.shape)
    np.testing.assert_array_equal(p_out, j_out)
    assert set(tr.profiler.stats) == {"host/copy", "device/dispatch", "host/gather"}


@pytest.mark.parametrize("target", TARGETS)
def test_uastc_transcoder_leaves_the_path_to_the_dispatch(golden, target, monkeypatch):
    # one transcode_shards call a batch, inside "device/dispatch" after the
    # copy: which path a target takes (BC7's tile kernel, another target's
    # partition) is ops/dispatch.py's alone
    tr = UastcTranscoder(target, device="cpu")
    seen = []

    def spy(shards, t, out_device):
        seen.append(([s.shape for s in shards], t, out_device, {k: v.calls for k, v in tr.profiler.stats.items()}))
        return real(shards, t, out_device)

    real = tmod.transcode_shards
    monkeypatch.setattr(tmod, "transcode_shards", spy)
    out, err = tr.transcode(golden["bc7_in"])
    n = len(golden["bc7_in"])
    assert seen == [([(n, 16)], target, torch.device("cpu"), {"host/copy": 1})]
    np.testing.assert_array_equal(out, _golden_out(golden, target))
    assert not err.any()


@pytest.mark.parametrize("target", ("bc7", "rgba"))
def test_uastc_transcode_async_then_gather(golden, target):
    tr = UastcTranscoder(target, device="cpu")
    res = tr.transcode_async(torch.from_numpy(golden["bc7_in"]))
    assert res.n == len(golden["bc7_in"]) and res.out.device.type == "cpu"
    out, err = res.gather()
    np.testing.assert_array_equal(out, _golden_out(golden, target))
    assert not err.any()


def test_uastc_transcoder_flags_invalid_blocks_and_unknown_target(golden):
    blocks = golden["bc7_in"][:8].copy()
    blocks[3, 0] = 69  # invalid mode
    out, err = UastcTranscoder("bc7", device="cpu").transcode(blocks)
    j_out, j_err = jm.UastcTranscoder("bc7").transcode(blocks[3:4])
    assert err.tolist() == [False] * 3 + [True] + [False] * 4
    np.testing.assert_array_equal(out[3:4], j_out)
    assert j_err.tolist() == [True]
    with pytest.raises(BasisError, match="unknown target 'uastc'"):
        UastcTranscoder("uastc", device="cpu")


def test_corpus_transcoder_slices(golden):
    blocks = golden["bc7_in"]
    slices = [blocks[:100], blocks[100:101], blocks[101:]]
    outs = CorpusTranscoder("astc", device="cpu").transcode_slices(slices)
    assert [len(o) for o in outs] == [100, 1, len(blocks) - 101]
    np.testing.assert_array_equal(np.concatenate(outs), golden["astc_out"])
    bad = blocks[:4].copy()
    bad[1, 0] = bad[2, 0] = 69
    for tr, err_type in ((CorpusTranscoder("bc7", device="cpu"), BasisError), (jm.CorpusTranscoder("bc7"), JaxBasisError)):
        with pytest.raises(err_type) as e:
            tr.transcode_slices([bad])
        assert str(e.value) == "2 invalid blocks in corpus batch"


def test_entries_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: UastcTranscoder("bc7"), lambda: Etc1sMultiCorpusTranscoder("rgba"),
                 lambda: Etc1sCorpusTranscoder(np.zeros((1, 4), np.uint8), np.zeros((1, 4), np.uint8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _rand_etc1s_file(rng, E, S, slice_lens, alpha=False, work=Etc1sFileWork):
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    slices = [(rng.integers(0, E, n).astype(np.int32), rng.integers(0, S, n).astype(np.int32)) for n in slice_lens]
    alpha_slices = None
    if alpha:
        alpha_slices = [(rng.integers(0, E, n).astype(np.int32), rng.integers(0, S, n).astype(np.int32))
                        for n in slice_lens]
    return work(endpoints, selectors, slices, alpha_slices)


def _jax_work(fw):
    return jm.Etc1sFileWork(fw.endpoints, fw.selectors, fw.slices, fw.alpha_slices)


def _mixed_files():
    rng = np.random.default_rng(42)
    return [
        _rand_etc1s_file(rng, 17, 11, (24, 6)),
        _rand_etc1s_file(rng, 33, 29, (40,), alpha=True),
        _rand_etc1s_file(rng, 5, 7, (12, 12, 3)),
        _rand_etc1s_file(rng, 64, 48, (16,), alpha=True),
    ]


def _assert_same_files(got, want):
    assert len(got) == len(want)
    for g_slices, w_slices in zip(got, want):
        assert len(g_slices) == len(w_slices)
        for g, w in zip(g_slices, w_slices):
            g = np.asarray(g)
            w = np.asarray(w)
            assert (g.dtype, g.shape) == (w.dtype, w.shape)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("target", ("rgba", "etc1"))
def test_multifile_etc1s_matches_per_file_and_jax(target):
    files = _mixed_files()
    multi = Etc1sMultiCorpusTranscoder(target, device="cpu").transcode_files(files)
    per_file = [
        Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, target, device="cpu").transcode_slices(
            fw.slices, fw.alpha_slices if target == "rgba" else None)
        for fw in files
    ]
    _assert_same_files(multi, per_file)
    _assert_same_files(multi, jm.Etc1sMultiCorpusTranscoder(target).transcode_files([_jax_work(f) for f in files]))


def test_multifile_etc1s_resident_returns_tensors():
    files = _mixed_files()[:1]
    host = Etc1sMultiCorpusTranscoder("rgba", device="cpu").transcode_files(files)
    res = Etc1sMultiCorpusTranscoder("rgba", device="cpu").transcode_files(files, resident=True)
    for h_slices, d_slices in zip(host, res):
        for h, d in zip(h_slices, d_slices):
            assert isinstance(d, torch.Tensor) and d.dtype == torch.uint32
            np.testing.assert_array_equal(d.view(torch.int32).numpy().view(np.uint32), h)


def test_multifile_etc1s_zero_slice_files():
    rng = np.random.default_rng(11)
    empty = Etc1sFileWork(np.zeros((3, 4), np.uint8), np.zeros((3, 4), np.uint8), slices=[])
    full = _rand_etc1s_file(rng, 9, 9, (8, 5))
    for target in ("rgba", "etc1"):
        tr = Etc1sMultiCorpusTranscoder(target, device="cpu")
        assert tr.transcode_files([]) == []
        assert tr.transcode_files([empty]) == [[]]
        got = tr.transcode_files([empty, full, empty])
        assert got[0] == [] and got[2] == []
        want = jm.Etc1sMultiCorpusTranscoder(target).transcode_files([_jax_work(empty), _jax_work(full)])
        _assert_same_files(got[1:2], want[1:])


@pytest.mark.parametrize("case", ["ep", "sel", "unpaired"])
def test_etc1s_alpha_mismatch_messages(case):
    msgs = []
    for pkg_work, tr, err_type in ((Etc1sFileWork, Etc1sMultiCorpusTranscoder("rgba", device="cpu"), BasisError),
                                   (jm.Etc1sFileWork, jm.Etc1sMultiCorpusTranscoder("rgba"), JaxBasisError)):
        fw = _rand_etc1s_file(np.random.default_rng(4), 9, 9, (8,), alpha=True, work=pkg_work)
        a_ep, a_sel = fw.alpha_slices[0]
        fw.alpha_slices = {"ep": [(a_ep[:4], a_sel)], "sel": [(a_ep, a_sel[:4])], "unpaired": []}[case]
        with pytest.raises(err_type) as e:
            tr.transcode_files([fw])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_etc1s_corpus_alpha_mismatch_and_target_messages():
    rng = np.random.default_rng(5)
    fw = _rand_etc1s_file(rng, 9, 9, (8,), alpha=True)
    tr = Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, "rgba", device="cpu")
    jtr = jm.Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, "rgba")
    short = [(fw.alpha_slices[0][0][:3], fw.alpha_slices[0][1][:3])]
    for t, err_type in ((tr, BasisError), (jtr, JaxBasisError)):
        with pytest.raises(err_type, match="^RGB slice and Alpha slice have different dimensions$"):
            t.transcode_slices(fw.slices, short)
    for make, jmake in ((lambda: Etc1sMultiCorpusTranscoder("bc7", device="cpu"), lambda: jm.Etc1sMultiCorpusTranscoder("bc7")),
                        (lambda: Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, "astc", device="cpu"),
                         lambda: jm.Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, "astc"))):
        with pytest.raises(BasisError) as e:
            make()
        with pytest.raises(JaxBasisError) as je:
            jmake()
        assert str(e.value) == str(je.value) and str(e.value).startswith("unsupported ETC1S corpus target")


def _budget_files():
    rng = np.random.default_rng(7)
    return [
        _rand_etc1s_file(rng, 40, 8, (16, 5)),
        _rand_etc1s_file(rng, 50, 8, (24,)),
        _rand_etc1s_file(rng, 10, 8, (8,)),
        _rand_etc1s_file(rng, 90, 8, (12,)),
    ]


def test_codebook_budget_split_at_cap_64(monkeypatch):
    files = _budget_files()
    groups = tmod._split_by_codebook_budget(files, cap=64)
    assert [[fw.endpoints.shape[0] for fw in g] for g in groups] == [[40], [50, 10], [90]]
    tr = Etc1sMultiCorpusTranscoder("rgba", device="cpu")
    etc1s.reset_counts()
    monkeypatch.setattr(tmod, "MAX_BATCH_CODEBOOK_ENTRIES", 64)
    split = tr.transcode_files(files)
    assert etc1s.plain_call_counts()["rgba"] == 3  # one call a group
    monkeypatch.setattr(jtmod, "MAX_BATCH_CODEBOOK_ENTRIES", 64)
    _assert_same_files(split, jm.Etc1sMultiCorpusTranscoder("rgba").transcode_files([_jax_work(f) for f in files]))
    monkeypatch.undo()
    etc1s.reset_counts()
    _assert_same_files(tr.transcode_files(files), split)
    assert etc1s.plain_call_counts()["rgba"] == 1


def test_default_cap_keeps_shifted_indices_in_uint16():
    assert tmod.MAX_BATCH_CODEBOOK_ENTRIES == 1 << 16
    rng = np.random.default_rng(8)
    # 32 files of 2,048 entries fill one group to the cap exactly; the 33rd
    # starts a second group, so no shifted index passes 65,535
    files = [_rand_etc1s_file(rng, 2048, 2048, (4,)) for _ in range(33)]
    for f in files:
        f.slices = [(np.full(4, 2047, np.int32), np.full(4, 2047, np.int32))]
    groups = tmod._split_by_codebook_budget(files)
    assert [len(g) for g in groups] == [32, 1]
    for g in groups:
        _, _, ep, sel, _, _ = tmod._batch_etc1s_files(g, False)
        assert max(ep.max(), sel.max()) <= 0xFFFF
    # a lone file of the largest codebook a .basis file can hold fits too
    assert [len(g) for g in tmod._split_by_codebook_budget([_rand_etc1s_file(rng, 65535, 65535, (1,))])] == [1]


def test_profiler_report_matches_jax_and_trace_writes(tmp_path):
    from basisu_rs_tpu.utils.profiling import Profiler as JaxProfiler
    from basisu_rs_tpu_torch.utils.profiling import Profiler, StageStats, trace

    mine, ref = Profiler(), JaxProfiler()
    for p in (mine, ref):
        p.stats["host/partition"].calls, p.stats["host/partition"].seconds = 2, 0.5
        p.stats["host/partition"].texels = 1 << 20
        with p.stage("device/dispatch"):
            pass
        p.stats["device/dispatch"].seconds = 0.25
    assert mine.report() == ref.report()
    assert mine.stats["device/dispatch"].calls == 1
    assert StageStats(texels=16, seconds=2.0).mtexels_per_s == 8e-6
    with trace(None):
        pass
    with trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
