"""Command-line interface of the PyTorch port: inspect and transcode .basis
files.

  python -m basisu_rs_tpu_torch info tex.basis
  python -m basisu_rs_tpu_torch transcode tex.basis --target bc7 -o out_dir
  python -m basisu_rs_tpu_torch selftest

Port of `basisu_rs_tpu/__main__.py` (the reference crate has no CLI; this is
a convenience layer over the same API surface).  `--device {cuda,cpu}`
takes the place of the JAX CLI's `--platform`: the default `cuda` runs on
the card and fails without one; `cpu` runs the plain PyTorch versions.
`transcode --mesh N` shards the device work over the first N cards
(`parallel.make_mesh`; a bad N exits with rc 2), or with `--device cpu`
over N CPU "devices"; `uastc` ignores it, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cmd_info(args) -> int:
    from .container.basis import check_file_checksum, read_header, read_slice_descs

    buf = Path(args.file).read_bytes()
    h = read_header(buf)
    descs = read_slice_descs(buf, h)
    fmt = {0: "ETC1S", 1: "UASTC4x4"}.get(h.tex_format, f"unknown({h.tex_format})")
    out = {
        "format": fmt,
        "version": h.ver,
        "data_size": h.data_size,
        "data_crc_ok": check_file_checksum(buf, h),
        "total_images": h.total_images,
        "total_slices": h.total_slices,
        "has_alpha": h.has_alpha,
        "y_flipped": h.has_y_flipped,
        "etc1s": {
            "endpoints": h.total_endpoints,
            "selectors": h.total_selectors,
        }
        if h.tex_format == 0
        else None,
        "slices": [
            {
                "image": d.image_index,
                "level": d.level_index,
                "size": [d.orig_width, d.orig_height],
                "blocks": [d.num_blocks_x, d.num_blocks_y],
                "bytes": d.file_size,
                "alpha": d.has_alpha,
            }
            for d in descs
        ],
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_transcode(args) -> int:
    from . import read_to_astc, read_to_bc7, read_to_etc1, read_to_etc2, read_to_rgba, read_to_uastc

    readers = {
        "rgba": read_to_rgba,
        "astc": read_to_astc,
        "bc7": read_to_bc7,
        "etc1": read_to_etc1,
        "etc2": read_to_etc2,
        "uastc": read_to_uastc,
    }
    # container/target compatibility is checked before any transcode work
    if args.container == "png" and args.target != "rgba":
        print("--container png requires --target rgba", file=sys.stderr)
        return 2
    if args.container in ("ktx", "ktx2") and args.target == "uastc":
        print("uastc has no KTX format mapping; use --container bin", file=sys.stderr)
        return 2

    buf = Path(args.file).read_bytes()
    kwargs = {"device": args.device}
    if args.mesh and args.target != "uastc":
        from .parallel.mesh import make_mesh, mesh_devices

        try:
            # --device cpu asked for the CPU: N CPU "devices" even where cards exist
            kwargs["mesh"] = mesh_devices(["cpu"] * args.mesh) if args.device == "cpu" else make_mesh(args.mesh)
        except ValueError as e:
            print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
            return 2
    result = readers[args.target](buf, **kwargs)
    images = result[1] if args.target == "rgba" else result
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.file).stem

    if args.container == "png":
        from .container.png import write_png

        for i, img in enumerate(images):
            path = outdir / f"{stem}_{i}.png"
            path.write_bytes(write_png(img))
            print(f"wrote {path} ({img.w}x{img.h})")
        return 0

    if args.container in ("ktx", "ktx2"):
        from .container.basis import TexFormat, read_header, read_slice_descs
        from .container.ktx import group_mip_chains, write_ktx
        from .container.ktx2 import write_ktx2

        h = read_header(buf)
        descs = read_slice_descs(buf, h)
        named = []  # (file suffix, mip chains)
        if h.texture_format() == TexFormat.ETC1S and h.has_alpha and args.target == "rgba":
            # RGBA decode merges each RGB+A slice pair into one image
            named.append(("", group_mip_chains(images, descs[::2])))
        elif h.texture_format() == TexFormat.ETC1S and h.has_alpha and args.target == "etc1":
            # ETC1 decodes every slice separately: the alpha slices are their
            # own (grayscale) ETC1 images sharing (image, level) with their
            # RGB partners - split them into parallel _alpha chains instead
            # of letting them collide as bogus extra mip levels
            rgb = [(img, d) for img, d in zip(images, descs, strict=True) if not d.has_alpha]
            alp = [(img, d) for img, d in zip(images, descs, strict=True) if d.has_alpha]
            named.append(("", group_mip_chains([i for i, _ in rgb], [d for _, d in rgb])))
            named.append(("_alpha", group_mip_chains([i for i, _ in alp], [d for _, d in alp])))
        else:
            named.append(("", group_mip_chains(images, descs)))
        writer = write_ktx2 if args.container == "ktx2" else write_ktx
        for suffix, chains in named:
            for i, chain in enumerate(chains):
                path = outdir / f"{stem}_{i}{suffix}.{args.target}.{args.container}"
                blob = writer(chain, args.target)
                path.write_bytes(blob)
                print(f"wrote {path} ({chain[0].w}x{chain[0].h}, {len(chain)} level(s), {len(blob)} bytes)")
        return 0

    for i, img in enumerate(images):
        path = outdir / f"{stem}_{i}.{args.target}.bin"
        data = img.data.cpu().numpy()
        data.tofile(path)
        meta = {"w": img.w, "h": img.h, "stride": img.stride, "target": args.target}
        (outdir / f"{stem}_{i}.{args.target}.json").write_text(json.dumps(meta))
        print(f"wrote {path} ({img.w}x{img.h}, {data.nbytes} bytes)")
    return 0


def cmd_selftest(args) -> int:
    """Transcode the golden corpus through every target and verify parity."""
    from .api import transcode_uastc_blocks
    from .models.transcoder import to_host

    fixture = Path(__file__).parent.parent / "tests" / "fixtures" / "golden_blocks.npz"
    d = np.load(fixture)
    failures = 0
    for target in ("rgba", "astc", "bc7", "etc1", "etc2"):
        out, err = transcode_uastc_blocks(d[f"{target}_in"], target, device=args.device)
        out, err = to_host(out), err.cpu().numpy()
        ok = not err.any() and out.shape == d[f"{target}_out"].shape and (out == d[f"{target}_out"]).all()
        print(f"{target}: {'OK' if ok else 'FAIL'} ({len(out)} blocks)")
        failures += not ok
    return 1 if failures else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="basisu_rs_tpu_torch")
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where transcode and selftest run: the CUDA card (default; fails "
        "without one) or the plain PyTorch versions on the CPU",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="dump .basis header and slice table as JSON")
    pi.add_argument("file")
    pi.set_defaults(fn=cmd_info)

    pt = sub.add_parser("transcode", help="transcode a .basis file")
    pt.add_argument("file")
    pt.add_argument("--target", choices=["rgba", "astc", "bc7", "etc1", "etc2", "uastc"], default="bc7")
    pt.add_argument(
        "--container",
        choices=["bin", "ktx", "ktx2", "png"],
        default="bin",
        help="output container: raw blocks + JSON metadata, a loadable KTX "
        "v1 / KTX2 texture per image (mip chains preserved), or PNG "
        "(rgba only)",
    )
    pt.add_argument("-o", "--output", default=".")
    pt.add_argument(
        "--mesh",
        type=int,
        default=0,
        metavar="N",
        help="shard the device work over an N-device mesh "
        "(0 = single device; uastc passthrough ignores it). Today more than "
        "one card is slower than one: one host thread enqueues every card's "
        "launches in turn",
    )
    pt.set_defaults(fn=cmd_transcode)

    ps = sub.add_parser("selftest", help="golden-corpus parity check on this host")
    ps.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
