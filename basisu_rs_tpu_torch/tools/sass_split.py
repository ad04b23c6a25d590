"""Where a UASTC kernel's SASS instructions go: an opcode histogram split
into the parts of its per-block work.

    python -m basisu_rs_tpu_torch.tools.sass_split SRC DUMP [DUMP ...]

Each DUMP is one kernel's SASS annotated with its inlined source lines, as
`tools/csrc_ab.py --dump MODES` writes it (lines_<variant>_<target>
_<mode>.txt); SRC is the copy of `csrc/` it was built from.  Every
instruction carries its chain of source frames, the innermost first; the
tool finds the function around each frame in SRC and gives the instruction
the part of the first frame that a rule of its target names (`PARTS`), else
"other".  For each DUMP it prints the count of each part and that part's
ten most frequent opcodes.  Runs anywhere: it reads text only.
"""

from __future__ import annotations

import argparse
import collections
import re
from pathlib import Path

_LINE_INFO = re.compile(r'^\s*//## File "([^"]+)", line (\d+)')
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);")
_DUMP_NAME = re.compile(r"lines_(.+)_(bc7|astc|rgba|etc1|etc2)_(\d+)\.txt$")
_IDENT = re.compile(r"([A-Za-z_]\w*)\s*\(")
_NOT_NAMES = {"__launch_bounds__", "if", "for", "while", "switch", "return", "sizeof", "static_cast"}

# Per target, the rules (function, first marker, last marker, part), tried
# in order on each frame: the frame matches where it lies in `function`
# and, with markers, in the lines from the first line that holds `first`
# up to (not including) the first later line that holds `last` (None: the
# function's end).
_LAUNCH = ("uastc_kernel", None, None, "launch")
PARTS = {
    "astc": [
        ("weight_stream", None, None, "weights"), ("invert_stream", None, None, "weights"),
        ("decode_weights", None, None, "weights"),
        ("uastc_to_astc", "// weights (astc.rs", "if constexpr (planes != 1)", "weights"),
        ("uastc_to_astc", "// Blue-contraction", "// weights (astc.rs", "encode"),
        ("uastc_to_astc", "if constexpr (planes != 1)", None, "encode"),
        ("mode8_to_astc", None, None, "encode"),
        ("uastc_to_astc", None, None, "decode"),
        _LAUNCH,
    ],
    "etc1": [
        ("etc1_selector_word", None, None, "emit"),
        ("etc1_block", "w1 = 0;", None, "emit"),
        ("fold_texel", None, None, "encode"), ("texel_luminance", None, None, "encode"),
        ("pack_quad_rgb", None, None, "encode"),
        ("etc1_block", None, None, "encode"), ("decode_trans_flags", None, None, "encode"),
        ("mode8_etc1", None, None, "encode"),
        ("etc_texels", None, None, "decode"),
        _LAUNCH,
    ],
    # K1: the weight read (per texel, or the weight stream), the endpoint
    # permutation and the subsets' inversion, the p-bit search, and the
    # emit of the endpoints and of the weights.  The rules name both the
    # per-weight form (decode_weights, extract_bit_dyn) and the word form
    # (bc7_weight_word), so a dump of either source splits alike.
    "bc7": [
        ("texel_weight", None, None, "weight decode"), ("decode_weights", None, None, "weight decode"),
        ("weight_stream", None, None, "weight decode"),
        ("extract_bit_dyn", None, None, "permute/invert"), ("spread_lanes3", None, None, "permute/invert"),
        ("remove_zero", None, None, "weight emit"),
        ("bc7_weight_word", "// drop the anchors'", None, "weight emit"),
        ("bc7_weight_word", "// BC7 subsets j >= 1", "// drop the anchors'", "permute/invert"),
        ("bc7_weight_word", None, None, "weight decode"),
        ("uastc_to_bc7", "// weights (bc7.rs", None, "weight emit"),
        ("uastc_to_bc7", "// endpoints (bc7.rs", "// weights (bc7.rs", "endpoint emit"),
        ("uastc_to_bc7", "// p-bits or plain", "// endpoints (bc7.rs", "p-bits"),
        ("uastc_to_bc7", "// BC7 subset j takes", "// p-bits or plain", "permute/invert"),
        ("uastc_to_bc7", "decode_weights<M>(l, pat, w);", "int32_t pr[nsub]", "weight decode"),
        ("uastc_to_bc7", None, None, "decode"),
        _LAUNCH,
    ],
    "rgba": [("uastc_to_rgba", None, None, "decode"), _LAUNCH],
}
PARTS["etc2"] = [("eac_words", None, None, "alpha"), ("etc2_alpha_texels", None, None, "alpha")] + PARTS["etc1"]


def functions(path: Path) -> list:
    """[(name, first line, last line)] of the top-level functions and
    structs of a C++ source (1-based lines): a definition opens at brace
    depth 0 (namespaces do not count) and closes where the depth returns
    to 0."""
    out = []
    depth, sig, start = 0, "", None
    for no, line in enumerate(path.read_text().splitlines(), 1):
        code = line.split("//")[0]
        if depth == 0 and code.strip() and not code.lstrip().startswith("#"):
            if start is None:
                start = no
            sig += " " + code
        opens, closes = code.count("{"), code.count("}")
        if depth == 0 and opens and sig:
            head = sig.split("{")[0]
            if head.strip().startswith("namespace"):
                sig, start = "", None
                continue
            names = [n for n in _IDENT.findall(head) if n not in _NOT_NAMES]
            struct = re.search(r"\b(?:struct|class)\s+(\w+)", head)
            name = names[0] if names and "=" not in head.split("(")[0] else (struct.group(1) if struct else None)
            if "=" in head and not names:
                name = None  # a table
            depth += opens - closes
            if depth == 0:
                if name:
                    out.append((name, start, no))
                sig, start = "", None
            else:
                cur = (name, start)
            continue
        if depth == 0 and code.rstrip().endswith(";"):
            sig, start = "", None
        if depth > 0:
            depth += opens - closes
            if depth == 0:
                if cur[0]:
                    out.append((cur[0], cur[1], no))
                sig, start = "", None
    return out


class Source:
    """The functions of each file of a csrc copy, and the rule ranges."""

    def __init__(self, src: Path):
        self.src = src
        self.funcs = {p.name: functions(p) for p in sorted(src.glob("*.cu*"))}
        self.text = {p.name: p.read_text().splitlines() for p in sorted(src.glob("*.cu*"))}

    def function_at(self, file: str, line: int):
        """(name, first, last) of the function around file:line, or None."""
        for f in self.funcs.get(Path(file).name, []):
            if f[1] <= line <= f[2]:
                return f
        return None

    def marker_line(self, file: str, first: int, last: int, marker: str):
        for no in range(first, last + 1):
            if marker in self.text[Path(file).name][no - 1]:
                return no
        return None

    def part(self, rules, frames) -> str:
        for file, line in frames:
            f = self.function_at(file, line)
            if f is None:
                continue
            for name, first, last, part in rules:
                if name != f[0]:
                    continue
                lo, hi = f[1], f[2]
                if first is not None:
                    lo = self.marker_line(file, f[1], f[2], first)
                    if lo is None:
                        continue
                    if last is not None:
                        end = self.marker_line(file, lo + 1, f[2], last)
                        hi = end - 1 if end is not None else f[2]
                if lo <= line <= hi:
                    return part
        return "other"


def split(src: Source, target: str, lines) -> dict:
    """{part: Counter(opcode)} of one kernel's annotated SASS."""
    rules = PARTS[target]
    out: dict = collections.defaultdict(collections.Counter)
    frames: list = []
    pending: list = []  # nvdisasm gives a chain as one line a frame, innermost first
    for line in lines:
        m = _LINE_INFO.match(line)
        if m:
            pending.append((m.group(1), int(m.group(2))))
            continue
        m = _INSTRUCTION.match(line)
        if not m:
            continue
        if pending:
            frames, pending = pending, []
        tokens = m.group(1).split()
        if tokens and tokens[0].startswith("@"):
            tokens = tokens[1:]
        if not tokens or tokens[0] == "NOP":
            continue
        out[src.part(rules, frames)][tokens[0].split(".")[0]] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("dumps", nargs="+", type=Path)
    args = ap.parse_args(argv)
    src = Source(args.src)
    for dump in args.dumps:
        m = _DUMP_NAME.search(dump.name)
        if not m:
            raise SystemExit(f"{dump}: not a lines_<variant>_<target>_<mode>.txt dump")
        parts = split(src, m.group(2), dump.read_text().splitlines())
        total = sum(sum(c.values()) for c in parts.values())
        print(f"{m.group(1)} {m.group(2)} mode {m.group(3)}: {total} SASS instructions")
        for part, counts in sorted(parts.items(), key=lambda kv: -sum(kv[1].values())):
            top = " ".join(f"{op} {n}" for op, n in counts.most_common(10))
            print(f"  {part:14s} {sum(counts.values()):5d}  {top}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
