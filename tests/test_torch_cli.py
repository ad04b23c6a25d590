"""PyTorch port: the CLI (python -m basisu_rs_tpu_torch) against the JAX
package's (python -m basisu_rs_tpu --platform cpu), on the CPU.

Both CLIs run in this process through their `main(argv)`: `info` JSON,
every container of `transcode` (files and bytes equal, tolerance 0), the
refusal codes and messages, `selftest`, and `transcode --mesh`.  The port
runs with `--device cpu`; its default `--device cuda` raises without a
card."""

import json

import pytest
import torch

from basisu_rs_tpu.__main__ import main as jax_main
from basisu_rs_tpu_torch.__main__ import main
from tests.test_ktx import _basis_with_mips
from tests.test_torch_ktx import _etc1s_alpha_file


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "tex.basis").write_bytes(_basis_with_mips())
    (d / "alpha.basis").write_bytes(_etc1s_alpha_file())
    return d


def _outputs(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("name", ["tex.basis", "alpha.basis"])
def test_info_json_equals_jax(files, capsys, name):
    assert main(["info", str(files / name)]) == 0
    mine = capsys.readouterr().out
    assert jax_main(["--platform", "cpu", "info", str(files / name)]) == 0
    assert json.loads(mine) == json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("name,target,container", [
    ("tex.basis", "bc7", "bin"),
    ("tex.basis", "uastc", "bin"),
    ("tex.basis", "etc2", "ktx"),
    ("tex.basis", "astc", "ktx2"),
    ("tex.basis", "rgba", "png"),
    ("tex.basis", "rgba", "ktx"),
    ("alpha.basis", "rgba", "ktx"),
    ("alpha.basis", "etc1", "ktx"),
    ("alpha.basis", "etc1", "ktx2"),
])
def test_transcode_outputs_equal_jax(files, tmp_path, capsys, name, target, container):
    args = ["transcode", str(files / name), "--target", target, "--container", container]
    assert main(["--device", "cpu", *args, "-o", str(tmp_path / "mine")]) == 0
    assert jax_main(["--platform", "cpu", *args, "-o", str(tmp_path / "ref")]) == 0
    mine, ref = _outputs(tmp_path / "mine"), _outputs(tmp_path / "ref")
    assert mine and list(mine) == list(ref)
    for k in mine:
        assert mine[k] == ref[k], k


@pytest.mark.parametrize("target,container", [("bc7", "png"), ("uastc", "ktx"), ("uastc", "ktx2")])
def test_transcode_refusals_equal_jax(files, tmp_path, capsys, target, container):
    args = ["transcode", str(files / "tex.basis"), "--target", target, "--container", container, "-o", str(tmp_path)]
    assert main(["--device", "cpu", *args]) == 2
    mine = capsys.readouterr().err
    assert jax_main(["--platform", "cpu", *args]) == 2
    assert mine == capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_selftest_on_cpu(capsys):
    assert main(["--device", "cpu", "selftest"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{t}: OK (608 blocks)" for t in ("rgba", "astc", "bc7", "etc1", "etc2")]


def test_default_device_needs_a_card(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["selftest"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["transcode", str(files / "tex.basis"), "-o", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["--device", "tpu", "selftest"])


@pytest.mark.parametrize("name,target", [("tex.basis", "bc7"), ("tex.basis", "rgba"), ("alpha.basis", "etc1"),
                                         ("tex.basis", "uastc")])
def test_transcode_mesh_writes_the_same_files(files, tmp_path, capsys, name, target):
    """--device cpu --mesh 3 shards over three CPU "devices" and writes the
    bytes the unsharded run writes (uastc ignores --mesh)."""
    args = ["--device", "cpu", "transcode", str(files / name), "--target", target]
    assert main([*args, "--mesh", "3", "-o", str(tmp_path / "mesh")]) == 0
    assert main([*args, "-o", str(tmp_path / "one")]) == 0
    mesh, one = _outputs(tmp_path / "mesh"), _outputs(tmp_path / "one")
    assert mesh and mesh == one


def test_transcode_mesh_needs_the_cards(files, tmp_path, capsys, monkeypatch):
    """On the card, more devices than exist exit with rc 2 and the mesh's
    message before any read, as the JAX CLI does; so does a negative N."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    args = ["transcode", str(files / "tex.basis"), "-o", str(tmp_path)]
    assert main([*args, "--mesh", "2"]) == 2
    assert capsys.readouterr().err == (
        "--mesh 2: requested a 2-device mesh but CUDA has 0 device(s); for a sharding dry run on CPU devices "
        "pass allow_cpu_fallback=True\n")
    assert not list(tmp_path.iterdir())
    for device in ("cuda", "cpu"):
        assert main(["--device", device, *args, "--mesh", "-1"]) == 2
        assert capsys.readouterr().err.startswith("--mesh -1: a mesh needs at least one device")
