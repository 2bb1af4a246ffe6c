"""The SASS of every kernel of another tree's ``vae_captioning_torch/csrc``
against this tree's, function by function: a guard that a change to one
kernel left the others' machine code as it was.

Each ``csrc/*.cu`` of both trees is compiled with ``nvcc -cubin`` and the
build's flags (all started together), disassembled with ``cuobjdump
-sass`` and its functions named through ``cu++filt``; a function prints
as gone, new, or DIFFERS with its instruction counts, and the last line
counts the identical and differing ones.  Exit 1 where any differs.

    python3 sass_compare.py <other tree>     # e.g. the parent commit, unpacked
                                             # by git archive; on a machine with nvcc
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from vae_captioning_torch import _ext

FLAGS = [f for f in _ext.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas=-v")]


def cubins(trees: dict, out: Path) -> dict:
    """{(tree, source stem): cubin path}, one nvcc each, all started together."""
    jobs = {}
    for tree, csrc in trees.items():
        for src in sorted(csrc.glob("*.cu")):
            cubin = out / f"{tree}_{src.stem}.cubin"
            jobs[(tree, src.stem)] = (cubin, subprocess.Popen(
                [_ext._nvcc(), *FLAGS, "-cubin", "-o", str(cubin), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (_, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"sass_compare: nvcc failed for {key}:\n{log}")
    return {key: cubin for key, (cubin, _) in jobs.items()}


def sass(cubin: Path) -> dict:
    """{demangled function name: its instructions, addresses dropped}."""
    bin_dir = Path(_ext._nvcc()).parent
    text = subprocess.run([bin_dir / "cuobjdump", "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = block.partition("\n")
        funcs[name.strip()] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip()
                               for line in body.splitlines()
                               if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    names = list(funcs)
    demangled = subprocess.run([bin_dir / "cu++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    return {d.split(">(")[0] if ">(" in d else d.split("(")[0]: funcs[n]
            for n, d in zip(names, demangled)}


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"other": Path(sys.argv[1]) / "vae_captioning_torch" / "csrc",
             "this": _ext.CSRC_DIR}
    with tempfile.TemporaryDirectory() as tmp:
        built = cubins(trees, Path(tmp))
        same = differ = 0
        for stem in sorted({stem for _, stem in built}):
            if ("other", stem) not in built or ("this", stem) not in built:
                print(f"{stem}: a source of one tree only")
                continue
            old, new = sass(built["other", stem]), sass(built["this", stem])
            for name, ins in old.items():
                if name not in new:
                    print(f"{stem}: {name}: gone")
                elif new[name] == ins:
                    same += 1
                else:
                    differ += 1
                    print(f"{stem}: {name}: DIFFERS ({len(ins)} -> {len(new[name])} instructions)")
            for name in sorted(set(new) - set(old)):
                print(f"{stem}: {name}: new")
    print(f"SASS: {same} functions identical, {differ} differ")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
