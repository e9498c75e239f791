"""Whether an edit left kernels' machine code alone: compile the same
sources from two checkouts with nvcc -cubin and compare cuobjdump's SASS
function by function.

    python -m continuousnf_tpu_torch.utils.sass_diff --old build/parent \\
        [--names k3_test_solve,k1_train_solve,k2_train_adjoint]

`--old` is the root of the other checkout (a `git archive` of the parent
unpacked under build/, say); the sources are `continuousnf_tpu_torch/ops/
csrc/<name>.cu` in both.  The cubins go to build/sass/ (git-ignored), one
nvcc process per source and checkout, all started together; this
checkout's sources are compiled twice, so that a difference nvcc makes
between two builds of one file shows beside the one between the checkouts.
The anonymous namespace's name in the mangled names (a hash of the path, its
length in the `_ZN<n>` prefix) differs between two paths of one source and
is stripped, in function names and in the instructions that name a
function, and runs of blanks are collapsed: cuobjdump pads each
instruction to a column that a new kernel in the same file can move, so
without it every line of an unchanged kernel would differ in its padding
alone.  A function only this checkout has (a new instance) is listed
apart.  Needs the CUDA toolkit; prints one line per source and one JSON
object, and exits nonzero if a function of the other checkout is missing
here or has other SASS.

    python -m continuousnf_tpu_torch.utils.sass_diff --old build/parent --preprocessed [--names all]

compares, instead, what nvcc compiles: each source preprocessed by `nvcc -E`
under the kernels' flags in both checkouts, its line markers dropped and
runs of blanks collapsed (comments, line breaks and #if-excluded code do not
count).  Equal token streams compile to the same code; it takes seconds
where the SASS comparison takes nvcc's full time.  `--names all`: every
source of this checkout's csrc/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import subprocess
from pathlib import Path

from ..ops._build import CSRC, NVCC_FLAGS, _nvcc

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "sass"
_HASH = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_MARKER = re.compile(r"\s*#\s*(line\s+)?\d+(\s|$)")


def sass_by_function(cubin: Path) -> dict:
    """{function (hash stripped): its SASS lines (addresses stripped, blanks
    collapsed)}."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(cubin)], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = _HASH.sub("<anon>", line.split("Function :")[1].strip())
            out[fn] = []
        elif fn is not None and line.strip():
            out[fn].append(" ".join(_HASH.sub("<anon>", _ADDR.sub("", line)).split()))
    return out


def compile_cubin(src: Path, tag: str) -> Path:
    """nvcc -cubin of `src` (the kernels' flags) into build/sass/."""
    OUT.mkdir(parents=True, exist_ok=True)
    cubin = OUT / f"{src.stem}-{tag}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)], check=True, capture_output=True,
                   text=True, timeout=900)
    return cubin


def preprocessed(src: Path) -> str:
    """`nvcc -E` of `src` under the kernels' flags, its line markers dropped
    and runs of blanks collapsed."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    text = subprocess.run([_nvcc(), *flags, "-E", str(src)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    return " ".join(" ".join(line for line in text.splitlines() if not _MARKER.match(line)).split())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="root of the other checkout")
    ap.add_argument("--names", default="k3_test_solve,k1_train_solve,k2_train_adjoint")
    ap.add_argument("--preprocessed", action="store_true", help="compare nvcc -E's token streams, not SASS")
    a = ap.parse_args(argv)
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if a.names == "all" else a.names.split(",")
    old_csrc = Path(a.old).resolve() / CSRC.relative_to(ROOT)
    if a.preprocessed:
        jobs = [old_csrc / f"{n}.cu" for n in names] + [CSRC / f"{n}.cu" for n in names]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            texts = list(pool.map(preprocessed, jobs))
        differ = [n for i, n in enumerate(names) if texts[i] != texts[len(names) + i]]
        for i, n in enumerate(names):
            print(f"{n}: {len(texts[len(names) + i].split())} tokens, "
                  + ("other tokens than the other checkout's" if n in differ else "the other checkout's tokens"))
        print(json.dumps({"sources": len(names), "differ": differ}))
        return 1 if differ else 0
    jobs = [(old_csrc / f"{n}.cu", "old") for n in names] + [(CSRC / f"{n}.cu", t) for t in ("new", "again")
                                                                  for n in names]
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        cubins = list(pool.map(lambda j: compile_cubin(*j), jobs))
    report, same_all = {}, True
    k = len(names)
    for i, n in enumerate(names):
        old, new, again = (sass_by_function(cubins[j * k + i]) for j in range(3))
        differ = sorted(f for f in old if old[f] != new.get(f))
        added = sorted(set(new) - set(old))
        self_differ = sorted(f for f in set(new) | set(again) if new.get(f) != again.get(f))
        same_all &= not differ
        report[n] = {"functions": len(new), "differ": differ, "new": added,
                     "differ_between_two_builds": self_differ}
        print(f"{n}: {len(new)} functions, {len(differ)} of the other checkout's {len(old)} with other SASS or "
              f"missing" + (f" ({differ})" if differ else "") + f", {len(added)} new"
              + f"; {len(self_differ)} between two builds of this one")
    print(json.dumps(report))
    return 0 if same_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
