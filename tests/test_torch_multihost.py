"""PyTorch port: multi-host fan-out (basisu_rs_tpu_torch/parallel/multihost.py)
against the JAX package's, on the CPU: deterministic corpus sharding, exact
global stats above 2^31, and a real 2-process torch.distributed run over
gloo on localhost."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

import basisu_rs_tpu.parallel.multihost as jmh
from basisu_rs_tpu_torch.parallel.multihost import global_stats, initialize, shard_corpus

TIMEOUT_S = 120


def test_shard_corpus_single_process_owns_all():
    paths = [f"f{i}" for i in range(7)]
    assert shard_corpus(paths) == jmh.shard_corpus(paths) == paths


def test_global_stats_single_process_no_overflow(monkeypatch):
    """Counts beyond int32, exact, and a single process never reaches
    torch.distributed."""
    def refuse(*args, **kwargs):
        raise AssertionError("a single process called torch.distributed")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    initialize()
    initialize(num_processes=1)
    assert not dist.is_initialized()
    assert global_stats(3_000_000_000, 5) == jmh.global_stats(3_000_000_000, 5) == (3_000_000_000, 5)


_WORKER = textwrap.dedent(
    """
    import sys
    import torch.distributed as dist

    from basisu_rs_tpu_torch.parallel.multihost import global_stats, initialize, shard_corpus

    pid = int(sys.argv[1])
    initialize(coordinator_address=sys.argv[2], num_processes=2, process_id=pid)
    assert dist.get_world_size() == 2 and dist.get_rank() == pid

    paths = [f"f{i}" for i in range(5)]
    mine = shard_corpus(paths)
    expected = [p for i, p in enumerate(paths) if i % 2 == pid]
    assert mine == expected, (mine, expected)

    # process 0 brings 3e9 texels (beyond int32) and 2^31 errors, process 1 a few
    t, e = global_stats(3_000_000_000 if pid == 0 else 7, 2**31 if pid == 0 else 2)
    assert (t, e) == (3_000_000_007, 2**31 + 2), (t, e)
    dist.destroy_process_group()
    print(f"proc{pid} ok")
    """
)


def test_two_process_gloo_smoke(tmp_path):
    """Two real processes join a gloo process group on localhost and check
    the sharding and the summed stats end to end; a hang fails the test
    after TIMEOUT_S seconds."""
    with socket.socket() as s:  # a free port; the close -> bind window is acceptable here
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid), f"localhost:{port}"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, env=env, cwd=repo_root)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"two-process gloo smoke timed out after {TIMEOUT_S} s")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} ok" in out
