"""--epic easter egg: re-runs the CLI with rainbow-colorized output
(capability parity: mythril/interfaces/epic.py — the reference pipes
through a lolcat clone; this one is a minimal ANSI rainbow filter)."""

import math
import os
import subprocess
import sys


def rainbow_print(line: str, freq: float = 0.1, offset: float = 0.0) -> None:
    out = []
    for i, ch in enumerate(line):
        r = int(math.sin(freq * i + offset) * 127 + 128)
        g = int(math.sin(freq * i + offset + 2 * math.pi / 3) * 127 + 128)
        b = int(math.sin(freq * i + offset + 4 * math.pi / 3) * 127 + 128)
        out.append(f"\x1b[38;2;{r};{g};{b}m{ch}")
    sys.stdout.write("".join(out) + "\x1b[0m\n")


def main() -> None:
    argv = [sys.executable, "-m", "mythril_tpu_torch"] + sys.argv[2:]
    env = dict(os.environ)
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, env=env)
    offset = 0.0
    assert proc.stdout is not None
    for raw in proc.stdout:
        rainbow_print(raw.decode(errors="replace").rstrip("\n"),
                      offset=offset)
        offset += 0.3
    sys.exit(proc.wait())


if __name__ == "__main__":
    main()
