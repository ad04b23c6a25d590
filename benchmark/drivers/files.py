"""Whole .basis file reads: every request is `read_to_<target>(buf)` of
one file held in host memory as bytes, as a loader hands it over; the
files are cycled in an order drawn from the seed.

Every seed gets the same textures (the traffic's sides and counts, one
texture a file with its full mip chain), with other blocks, codebooks and
indices, in another order."""

from __future__ import annotations

from types import SimpleNamespace

import time

import numpy as np
import torch

from .. import inputs
from ..reference import basis_file
from ..reference import etc1s as ref_etc1s
from ..reference import uastc as ref_uastc


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.fmt, self.target = config["format"], config["target"]
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        t0 = time.perf_counter()
        import basisu_rs_tpu_torch

        rng = np.random.default_rng(self.seed)
        sides = [int(side) for side, count in self.traffic["textures"] for _ in range(count)]
        if self.fmt == "uastc":
            self.pool = inputs.golden_blocks()
            self.files = [inputs.uastc_file(rng, s, self.pool) for s in sides]
        elif self.fmt == "etc1s":
            e, s_ = self.config["endpoints"], self.config["selectors"]
            self.files = [inputs.etc1s_file(rng, s, e, s_) for s in sides]
        else:
            raise ValueError(f"no file driver for format {self.fmt!r}")
        levels = [inputs.mip_chain(s) for s in sides]
        self.texels = [sum(w * h for w, h, _x, _y in chain) for chain in levels]
        self.blocks = [sum(x * y for _w, _h, x, y in chain) for chain in levels]
        self.order = rng.permutation(len(self.files)).tolist()
        read = getattr(basisu_rs_tpu_torch, f"read_to_{self.target}")

        def entry(buf):
            out = read(buf, device=self.device)
            return out[1] if isinstance(out, tuple) else out  # read_to_rgba gives (header, images)

        self.entry = entry
        t1 = time.perf_counter()
        # one pass, every output held: every file's sizes warmed up, and the
        # allocator holding what the window's sampled outputs (one a file) take
        held = [self.entry(buf) for buf in self.files]
        del held
        self.timings = {"inputs_s": t1 - t0, "warm_up_s": time.perf_counter() - t1}

    def _file(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def call(self, i: int):
        return self.entry(self.files[self._file(i)])

    def work(self, i: int) -> tuple[int, int]:
        f = self._file(i)
        return self.texels[f], self.blocks[f]

    def sample_key(self, i: int) -> int:
        return self._file(i)

    def release(self) -> None:
        self.__dict__.pop("entry", None)

    # -- the check: the reference parses the same bytes ----------------------

    def _reference(self, f: int, control: bool = False) -> list:
        buf = self.files[f]
        if self.fmt == "uastc":
            images = ref_uastc.file_images(buf, self.target, self.pool, control, self.__dict__.setdefault("_tables", {}))
            if any(im["err"].any() for im in images):
                raise basis_file.ReferenceError("the reference finds invalid blocks: the read must raise")
            return [SimpleNamespace(w=im["w"], h=im["h"], data=torch.from_numpy(im["data"]).to(self.device))
                    for im in images]
        if self.target != "rgba":
            raise basis_file.ReferenceError(f"no ETC1S reference for target {self.target!r}")
        return [SimpleNamespace(**im) for im in ref_etc1s.file_rgba_images(buf, self.device, control)]

    def control_outputs(self, keys) -> dict:
        """The control's images of each file, in the program's form."""
        return {f: self._reference(f, control=True) for f in keys}

    def check(self, samples) -> dict:
        bad_bytes = bad_images = bad_requests = 0
        for i, images in samples:
            ref = self._reference(self.sample_key(i))
            missing = ref[len(images) :]
            wrong_images = len(missing) + max(0, len(images) - len(ref))
            wrong_bytes = sum(want.data.numel() for want in missing)
            for got, want in zip(images, ref):
                data = got.data.reshape(-1).view(torch.uint8)
                if (got.w, got.h, data.numel()) != (want.w, want.h, want.data.numel()):
                    wrong_images += 1
                    wrong_bytes += want.data.numel()
                else:
                    wrong_bytes += int((data != want.data).sum())
            bad_bytes += wrong_bytes
            bad_images += wrong_images
            bad_requests += (wrong_bytes + wrong_images) > 0
        return {"bad_bytes": (bad_bytes, 0), "bad_images": (bad_images, 0), "bad_requests": (bad_requests, 0)}
