"""Corpus pipeline: host parse on worker threads + transcode on the main thread.

Port of `basisu_rs_tpu/models/pipeline.py`.  A thread pool reads each file
and checks its header and data CRC (host work that releases the GIL in the
C++ CRC) while the main thread calls `read_to_*` file by file, which parses
the container again, checks the CRC again, runs the ETC1S front-end (C++)
for ETC1S files and launches the kernels, sharded over `mesh` when one is
given.  Files that fail are reported in `errors`, not raised; progress can
be resumed from a `PipelineState`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

from ..base import BasisError
from ..container import basis as basis_mod
from ..ops.kernels import TARGETS
from ..parallel.mesh import resolve_mesh
from ..utils.profiling import Profiler


@dataclass
class FileResult:
    path: str
    images: list  # list of Image
    texels: int


@dataclass
class PipelineState:
    """Resumable progress marker."""

    done: set = field(default_factory=set)

    def mark(self, path: str) -> None:
        self.done.add(str(path))

    def pending(self, paths) -> list:
        return [p for p in paths if str(p) not in self.done]


class BasisCorpusPipeline:
    """Transcode a corpus of .basis files, UASTC and ETC1S, into `target`
    (one of the transcode targets, as the JAX package's constructor
    requires), with the file reads and CRC checks on `workers` threads.
    Runs on `device="cuda"` unless constructed with another device, or
    shards each file's device work over `mesh` (a device list,
    `parallel.make_mesh`), which then decides over `device`."""

    def __init__(self, target: str, workers: int = 4, device="cuda", mesh=None):
        if target not in TARGETS:
            raise BasisError(f"unknown target {target!r}")
        self.target = target
        self.workers = workers
        self.mesh = resolve_mesh(device, mesh)
        self.profiler = Profiler()

    # -- host-side stage (runs on worker threads) ---------------------------
    def _parse(self, path):
        with self.profiler.stage("host/parse+crc"):
            buf = Path(path).read_bytes()
            header = basis_mod.read_header(buf)
            if not basis_mod.check_file_checksum(buf, header):
                raise BasisError("Data CRC16 failed")
        return path, buf, header

    # -- full pipeline ------------------------------------------------------
    def run(self, paths, state: PipelineState | None = None):
        """Yields a FileResult per file (skipping state.done); a file that
        fails lands in the `errors` list as (path, exception)."""
        state = state or PipelineState()
        todo = state.pending(paths)
        self.errors: list = []

        readers = {
            "rgba": basis_mod.read_to_rgba,
            "astc": basis_mod.read_to_astc,
            "bc7": basis_mod.read_to_bc7,
            "etc1": basis_mod.read_to_etc1,
            "etc2": basis_mod.read_to_etc2,
        }
        reader = readers[self.target]

        with ThreadPoolExecutor(self.workers) as pool:
            parsed = pool.map(self._guard(self._parse), todo)
            for item in parsed:
                if isinstance(item, tuple) and len(item) == 2 and isinstance(item[1], Exception):
                    self.errors.append(item)
                    continue
                path, buf, header = item
                try:
                    # read_to_* spans the host container parse, (for ETC1S)
                    # the entropy front-end, and the launches
                    with self.profiler.stage("file/transcode"):
                        result = reader(buf, mesh=self.mesh)
                    images = result[1] if self.target == "rgba" else result
                    texels = sum(int(i.w) * int(i.h) for i in images)
                    state.mark(path)
                    yield FileResult(str(path), images, texels)
                except Exception as e:  # noqa: BLE001 - per-file isolation
                    self.errors.append((str(path), e))

    @staticmethod
    def _guard(fn):
        def wrapped(path):
            try:
                return fn(path)
            except Exception as e:  # noqa: BLE001
                return (str(path), e)

        return wrapped
