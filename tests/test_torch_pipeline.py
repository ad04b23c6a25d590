"""PyTorch port: the corpus pipeline (basisu_rs_tpu_torch/models/pipeline.py)
against the JAX package's, on the CPU.

The mixed corpus of tests/test_pipeline.py (two UASTC files, one ETC1S
file, one corrupt file) goes through both pipelines: the same images
(tolerance 0), the same `errors` (paths and messages) and the same resume
result; worker counts and a mesh do not change the images."""

import numpy as np
import pytest
import torch

from basisu_rs_tpu.models.pipeline import BasisCorpusPipeline as JaxPipeline
from basisu_rs_tpu.models.pipeline import PipelineState as JaxState
from basisu_rs_tpu_torch.api import BasisError
from basisu_rs_tpu_torch.models import BasisCorpusPipeline, PipelineState
from basisu_rs_tpu_torch.parallel import make_mesh
from tests.test_pipeline import _make_corpus


def _errors(pipe):
    return [(path, type(e).__name__, str(e)) for path, e in pipe.errors]


@pytest.mark.parametrize("target,workers", [("rgba", 1), ("rgba", 3), ("etc1", 2)])
def test_pipeline_matches_jax(tmp_path, golden, target, workers):
    paths = _make_corpus(tmp_path, golden)
    pipe = BasisCorpusPipeline(target, workers=workers, device="cpu")
    mine = list(pipe.run(paths))
    jpipe = JaxPipeline(target, workers=2)
    ref = list(jpipe.run(paths))
    assert [r.path for r in mine] == [r.path for r in ref]
    assert [r.texels for r in mine] == [r.texels for r in ref]
    for r, j in zip(mine, ref):
        assert len(r.images) == len(j.images)
        for img, j_img in zip(r.images, j.images):
            assert (img.w, img.h, img.stride) == (j_img.w, j_img.h, j_img.stride)
            np.testing.assert_array_equal(img.data.numpy(), np.asarray(j_img.data))
    assert _errors(pipe) == _errors(jpipe)
    assert len(pipe.errors) == 1 and pipe.errors[0][0].endswith("bad.basis")
    assert set(pipe.profiler.stats) == {"host/parse+crc", "file/transcode"}


def test_pipeline_resume_matches_jax(tmp_path, golden):
    paths = _make_corpus(tmp_path, golden)[:3]
    runs = []
    for pipe, state in ((BasisCorpusPipeline("bc7", workers=2, device="cpu"), PipelineState()),
                        (JaxPipeline("bc7", workers=2), JaxState())):
        first = [r.path for r in pipe.run(paths[:2], state)]
        # the ETC1S file remains, and ETC1S -> bc7 is refused, so it lands in errors
        rest = [r.path for r in pipe.run(paths, state)]
        runs.append((first, rest, sorted(state.done), _errors(pipe)))
    assert runs[0] == runs[1]
    first, rest, done, errors = runs[0]
    assert len(first) == 2 and rest == [] and len(done) == 2
    assert errors == [(str(paths[2]), "BasisError", "unsupported texture format")]


def test_pipeline_target_check_and_card(monkeypatch):
    with pytest.raises(BasisError, match="unknown target 'uastc'"):
        BasisCorpusPipeline("uastc", device="cpu")
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BasisCorpusPipeline("rgba")


@pytest.mark.parametrize("target", ["rgba", "etc1"])
def test_pipeline_mesh_matches_single_device(tmp_path, golden, target):
    """mesh= shards each file's device work (UASTC and ETC1S) and decides
    over device="cuda", which needs no card beside a mesh: the images and
    errors of the single-device pipeline."""
    paths = _make_corpus(tmp_path, golden)
    with pytest.warns(UserWarning, match="CPU devices"):
        mesh = make_mesh(3, allow_cpu_fallback=True)
    pipe = BasisCorpusPipeline(target, workers=2, mesh=mesh)
    assert [d.type for d in pipe.mesh] == ["cpu"] * 3
    sharded = list(pipe.run(paths))
    one = BasisCorpusPipeline(target, workers=2, device="cpu")
    single = list(one.run(paths))
    assert [r.path for r in sharded] == [r.path for r in single] and len(sharded) == 3
    for r, s in zip(sharded, single):
        assert r.texels == s.texels and len(r.images) == len(s.images)
        for img, s_img in zip(r.images, s.images):
            assert (img.w, img.h, img.stride) == (s_img.w, s_img.h, s_img.stride)
            assert torch.equal(img.data, s_img.data)
    assert _errors(pipe) == _errors(one)
