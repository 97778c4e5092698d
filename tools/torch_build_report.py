#!/usr/bin/env python3
"""Report what ptxas makes of the port's kernels, and hold them against
another tree's build.

    python3 tools/torch_build_report.py [--repo DIR] [--sources a.cu,b.cu]

Compiles each source of opticalflowhs_tpu_torch/csrc (or those named) with
the port's own nvcc command line (kernels/_build.py) and `-Xptxas -v`, and
prints, for every kernel, its registers a thread, stack frame and spill
stores and loads. With --repo, DIR's sources are built the same way and
each kernel's SASS (`cuobjdump -sass`, the anonymous namespace's hash
masked, and runs of blanks taken as one, since cuobjdump pads its columns
to the widest instruction of the whole object) is compared with this
tree's: "identical" means the two builds run the same instructions, with
the same encodings; otherwise the report counts the lines that differ
and says whether the two are the same lines in another order. Building
a tree against a copy of itself gives the tool's noise floor (ptxas has
ordered one source's instructions differently from one build to the
next). Needs a CUDA toolkit (nvcc, cuobjdump); builds into a temporary
directory. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from opticalflowhs_tpu_torch.kernels import _build  # noqa: E402

_ANON = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")
_ADDR = re.compile(r"^/\*[0-9a-f]+\*/ ")


def build(root: Path, names: list[str], out: Path) -> tuple[dict, dict]:
    """({kernel: ptxas line}, {kernel: SASS lines}) of root's sources, built
    one at a time: built all at once on a loaded machine, ptxas once gave
    K2 another instruction order than the same source built alone."""
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True)
    usage, sass = {}, {}
    for name in names:
        cmd = _build.compile_command(nvcc, root / "opticalflowhs_tpu_torch/csrc" / name,
                                     out / f"{name}.o")
        cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {root}/{name}:\n{text}")
        kernel = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _ANON.sub("", m.group(1))
                usage[kernel] = ""
            elif kernel and ("spill" in line or "registers" in line):
                usage[kernel] += line.split(":", 1)[-1].strip() + "; "
        cuobjdump = Path(nvcc).with_name("cuobjdump")
        dump = subprocess.run([str(cuobjdump), "-sass", str(out / f"{name}.o")],
                              capture_output=True, text=True, check=True).stdout
        for part in re.split(r"\n\s*Function : ", dump)[1:]:
            head, _, body = part.partition("\n")
            sass[_ANON.sub("", head.strip())] = [
                " ".join(line.split()) for line in _ANON.sub("", body).splitlines()
                if line.strip()]
    return usage, sass


def compare(mine: list[str] | None, theirs: list[str] | None) -> str:
    """How one kernel's SASS lines compare with another build's."""
    if theirs is None:
        return "absent there"
    if mine == theirs:
        return "identical"
    n = max(len(mine), len(theirs))
    changed = sum(a != b for a, b in zip(mine, theirs)) + abs(len(mine) - len(theirs))
    reordered = (sorted(_ADDR.sub("", x) for x in mine)
                 == sorted(_ADDR.sub("", x) for x in theirs))
    order = "; the same lines in another order" if reordered else ""
    return f"differs: {changed} of {n} lines{order}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", help="another tree to compare each kernel's SASS with")
    ap.add_argument("--sources", help="comma-separated csrc/*.cu names (default: all)")
    args = ap.parse_args()
    names = (args.sources.split(",") if args.sources
             else [p.name for p in _build.sources()])
    tmp = Path(tempfile.mkdtemp())
    try:
        usage, sass = build(HERE, names, tmp / "this")
        other = build(Path(args.repo).resolve(), names, tmp / "other") if args.repo else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report = {}
    for kernel, line in sorted(usage.items()):
        row = {"ptxas": line.strip("; ")}
        if other is not None:
            row["sass_vs_repo"] = compare(sass.get(kernel), other[1].get(kernel))
        report[kernel] = row
        print(f"{kernel}: {row}")
    print(json.dumps({"kernels": report, "repo": args.repo}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
