"""A/B of two checkouts of the package on the card, end to end: the
whole-call and file times that `chip_smoke.py`'s phases 5, 8, 12 (blocks),
15 (ETC1S entries), 9, 13, 16 (file reads), 20 (corpus) and 21 (pipeline)
print, for both checkouts in one process.

    python -m basisu_rs_tpu_torch.tools.e2e_ab ROOT_A ROOT_B [ROOT_C ...] [--rounds 5] [--only PREFIXES] [--json OUT]

Each ROOT holds a checkout of the repo; its `basisu_rs_tpu_torch/` is
imported under a module name of its own, so every copy runs in the same
process, on the same card, with the same inputs (built once, by this
checkout's `chip_smoke.py` input functions).  Each copy builds its own kernels.
Every workload's outputs are checked equal between the copies, then each
round times every workload on each copy back to back, the copy that goes
first rotating from round to round: blocks and ETC1S entries as the
median of 10 whole calls between CUDA events, file reads, the corpus and
the pipeline as the median of 3 host-clock calls followed by a device
sync.  Per workload the tool prints each copy's median over the rounds,
its ratio to A's and the range of the per-round ratios.  Whole calls at
this size are host-bound (the enqueue of up to 19 launches and one host
sync), and the host's speed drifts between processes and calls, so only
copies timed in one process, interleaved, compare; a second checkout of
A's commit as a further copy gives the floor of what two equal copies
read.  Importing this module runs nothing; the timing needs a card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def load_package(root: Path, alias: str) -> dict:
    """root's basisu_rs_tpu_torch imported as `alias`; returns the modules
    the workloads use, by their name in the package."""
    init = Path(root).resolve() / "basisu_rs_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    mods = {"": pkg}
    for sub in ("ops.build", "ops.etc1s", "models"):
        mods[sub] = importlib.import_module(f"{alias}.{sub}")
    return mods


def _tensors(x) -> list:
    """The tensors a workload's result holds, in order (images' data, a
    corpus' arrays, a pipeline's file results)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(x)]
    if hasattr(x, "images"):
        return _tensors(x.images)
    if hasattr(x, "data") and hasattr(x, "stride"):
        return [x.data]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def workloads(mods: dict, inputs: dict) -> dict:
    """{name: (fn, clock)} of one copy; clock is "events" or "host"."""
    pkg, etc1s, models = mods[""], mods["ops.etc1s"], mods["models"]
    full, buf, etc1s_files = inputs["full"], inputs["uastc_buf"], inputs["etc1s_files"]
    endpoints, selectors, idx = inputs["endpoints"], inputs["selectors"], inputs["idx"]
    alpha_tabs = [etc1s.codebook_tensor(w, full.device)
                  for w in (etc1s.pack_endpoints(endpoints), etc1s.pack_selectors(selectors))]
    work = {f"blocks/{t}": (lambda t=t: pkg.transcode_uastc_blocks(full, t), "events")
            for t in ("bc7", "astc", "rgba", "etc1", "etc2")}
    work.update({
        "etc1s/rgba": (lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1]), "events"),
        "etc1s/rgba_alpha": (lambda: etc1s.run_etc1s_rgba(endpoints, selectors, idx[0], idx[1], (idx[2], idx[3])),
                             "events"),
        "etc1s/alpha": (lambda: etc1s.etc1s_kernel("alpha")(*alpha_tabs, idx[0], idx[1]), "events"),
        "etc1s/etc1": (lambda: etc1s.run_etc1s_etc1(endpoints, selectors, idx[0], idx[1]), "events"),
    })
    for t in ("bc7", "astc", "rgba", "etc1", "etc2"):
        work[f"file/uastc/{t}"] = (lambda t=t: getattr(pkg, f"read_to_{t}")(buf), "host")
    for name, b in etc1s_files.items():
        for t in ("rgba", "etc1"):
            work[f"file/etc1s-{name}/{t}"] = (lambda t=t, b=b: getattr(pkg, f"read_to_{t}")(b), "host")
    for n, sl in inputs["corpus"].items():
        work[f"corpus/bc7/{n}"] = (lambda sl=sl: models.CorpusTranscoder("bc7").transcode_slices(sl), "host")
    paths = inputs["pipeline_paths"]
    for w in (1, 4):
        work[f"pipeline/workers={w}"] = (
            lambda w=w: list(models.BasisCorpusPipeline("rgba", workers=w).run(paths)), "host")
    return work


def build_inputs(dev, tmp: Path) -> tuple:
    """(inputs, the chip_smoke module): chip_smoke's inputs of the timed
    phases, built once for both copies."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from ..container.writer import write_uastc_basis

    full_np = cs.tiled_blocks(np.load(cs.FIXTURE)["bc7_in"])
    endpoints, selectors, idx_np = cs.etc1s_streams()
    corpus = {}
    for textures, width in cs.CORPUS_SIZES:
        sl = [s for _, _, s in cs.mip_slices(full_np, textures, width)]
        corpus[sum(len(s) for s in sl)] = sl
    paths, _ = cs.pipeline_corpus(tmp, full_np, endpoints, selectors)
    return dict(
        full=torch.from_numpy(full_np).to(dev),
        uastc_buf=write_uastc_basis(cs.uastc_texture_slices(full_np)),
        etc1s_files={name: b for name, (b, _, _) in cs.etc1s_texture_files(endpoints, selectors, idx_np).items()},
        endpoints=endpoints,
        selectors=selectors,
        idx=[torch.from_numpy(a).to(dev) for a in idx_np],
        corpus=corpus,
        pipeline_paths=paths,
    ), cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", type=Path, nargs="+", help="two or more checkouts; the first is the baseline A")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="", help="comma list of workload name prefixes to time (default: all)")
    ap.add_argument("--json", type=Path, help="also write the per-round times here")
    args = ap.parse_args(argv)
    if len(args.roots) < 2:
        ap.error("give at least two checkouts")
    if not torch.cuda.is_available():
        raise SystemExit("e2e_ab: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    labels = [chr(ord("A") + k) for k in range(len(args.roots))]
    copies = {lab: load_package(root, f"e2e_ab_{lab.lower()}") for lab, root in zip(labels, args.roots)}
    for (lab, mods), root in zip(copies.items(), args.roots):
        so, seconds = mods["ops.build"].build()
        print(f"{lab} = {root}: built {so.name} in {seconds:.2f} s")
    with tempfile.TemporaryDirectory(prefix="e2e_ab_") as tmp:
        inputs, cs = build_inputs(dev, Path(tmp))
        card = cs.card_facts()
        work = {lab: workloads(mods, inputs) for lab, mods in copies.items()}
        prefixes = tuple(x for x in args.only.split(",") if x)
        names = [n for n in work["A"] if not prefixes or n.startswith(prefixes)]
        for name in names:
            base = _tensors(work["A"][name][0]())
            for lab in labels[1:]:
                got = _tensors(work[lab][name][0]())
                torch.cuda.synchronize()
                cs.require(len(got) == len(base) > 0 and all(
                    a.shape == b.shape and torch.equal(a, b.to(a.device)) for a, b in zip(base, got)),
                    f"{name}: copy {lab}'s outputs differ from A's")
            del base, got
        print(f"outputs of {', '.join(labels)} equal on all {len(names)} workloads [{card}]")
        times = {name: {lab: [] for lab in labels} for name in names}
        for r in range(args.rounds):
            order = labels[r % len(labels):] + labels[: r % len(labels)]
            for name in names:
                for lab in order:  # the copies of one workload back to back, the first rotating
                    fn, clock = work[lab][name]
                    if clock == "events":
                        fn()  # warm-up: the host-clock workloads take their median of 3 instead
                    ms = statistics.median(cs.times_ms(fn)) if clock == "events" else cs.host_ms(fn)
                    times[name][lab].append(ms)
                torch.cuda.empty_cache()
    print(f"median over {args.rounds} rounds (each workload's copies back to back, the first rotating), ms; "
          f"X/A = median of X over median of A, per round = the range of the rounds' X/A [{card}]")
    summary = {}
    for name in names:
        a = times[name]["A"]
        summary[name] = {"A_ms": statistics.median(a), "A": a}
        line = f"{name:26s} A {statistics.median(a):9.4f}"
        for lab in labels[1:]:
            x = times[name][lab]
            ratios = [y / z for z, y in zip(a, x)]
            summary[name].update({f"{lab}_ms": statistics.median(x), lab: x,
                                  f"{lab}/A": statistics.median(x) / statistics.median(a),
                                  f"{lab}/A_rounds": [min(ratios), max(ratios)]})
            line += (f"  {lab} {statistics.median(x):9.4f} {lab}/A {summary[name][f'{lab}/A']:.4f} "
                     f"({min(ratios):.2f}-{max(ratios):.2f})")
        print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=card, rounds=args.rounds, roots=[str(r) for r in args.roots],
                                             workloads=summary), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
