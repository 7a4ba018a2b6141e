"""Whether nvcc's ``--split-compile=0``, which cuts ``screen.cu``'s
compile by about a third, changes the code its kernels run: the source
built with ``_build``'s flags twice at once, with the flag and without
it, then each kernel's SASS (``cuobjdump -sass``) and resources
(``cuobjdump -res-usage``: registers, stack, local memory) and the
compiler's spill lines (``ptxas -v``) compared.

    python3 tools/split_compile.py

Prints a line a kernel (whether its SASS and resources are the same,
its resources and spills), each build's compile seconds and a summary
line; exits 1 where any kernel differs. Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``), not a card.
"""

import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from mythril_tpu_torch import _build  # noqa: E402

FUNC = re.compile(r"^\s*Function\s*:?\s*([^\s:]+)")
SPILL = re.compile(r"Function properties for (\S+)\s*\n\s*(.*spill.*)")
SOURCE, FLAG = "screen.cu", "--split-compile=0"


def per_kernel(lib: str, what: str, keep) -> dict:
    """{kernel: its lines of ``cuobjdump -<what>`` of ``lib`` that
    ``keep`` (the instructions, the resource line) accepts}"""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                          f"-{what}", lib], capture_output=True, text=True,
                         check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = FUNC.match(line)
        if m:
            name = m.group(1)
            found[name] = []
        elif name is not None and keep(line.strip()):
            found[name].append(line.strip())
    return found


def compare(out: str) -> int:
    """Both builds into ``out``, compared."""
    src = os.path.join(_build.CSRC, SOURCE)
    own = [FLAG]
    builds = {}
    t0 = time.perf_counter()
    for tag, extra in (("with", own), ("without", [])):
        lib = os.path.join(out, f"{tag}.so")
        builds[tag] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS + extra + ["-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs, secs = {}, {}
    for tag, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        secs[tag] = time.perf_counter() - t0
        if proc.returncode != 0:
            print(log.decode(errors="replace"), file=sys.stderr)
            return 2
        logs[tag] = dict(SPILL.findall(log.decode(errors="replace")))
    sass = {t: per_kernel(lib, "sass", lambda x: x.startswith("/*"))
            for t, (lib, _) in builds.items()}
    res = {t: per_kernel(lib, "res-usage", lambda x: "REG:" in x)
           for t, (lib, _) in builds.items()}
    names = sorted(set(sass["with"]) | set(sass["without"]))
    differ = 0
    for name in names:
        same = (sass["with"].get(name) == sass["without"].get(name)
                and res["with"].get(name) == res["without"].get(name))
        if same:
            print(f"{name}: the same SASS; {res['with'].get(name)} "
                  f"{logs['with'].get(name)}")
        else:
            differ += 1
            print(f"{name}: SASS or resources differ; with {own}: "
                  f"{res['with'].get(name)} {logs['with'].get(name)}; "
                  f"without: {res['without'].get(name)} "
                  f"{logs['without'].get(name)}")
    print(f"{SOURCE}: built with {own} in {secs['with']:.1f} s and "
          f"without in {secs['without']:.1f} s (at once)")
    print(f"{SOURCE}: {len(names)} kernels, {len(names) - differ} with "
          f"the same SASS and resources with {own} and without, "
          f"{differ} differ")
    return 1 if differ else 0


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="split_compile_") as out:
        return compare(out)


if __name__ == "__main__":
    sys.exit(main())
