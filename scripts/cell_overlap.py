"""What phase 20's production cell moves in the phases it runs beside.

``chip_smoke.py`` starts the dry run of its production cell
(``DRYRUN_CELL``, minutes of one CPU core) in a subprocess after the
build, at the lowest CPU priority, so that it runs beside phases 3-19.
This runs ``chip_smoke.py`` twice on one card: first as it is (the cell
beside the phases), then with the cell started at phase 20, after every
other phase.  It prints each phase's seconds and every timed field of the
kernels line (``ms``, ``plain_ms``, ``library_ms`` and the other ``*_ms``
/ ``*_us`` fields; not the bounds, which are computed) side by side, each
with its ratio beside / after, and the medians of those ratios, as one
JSON line; both logs go to ``results/cell_overlap/{beside,after}.log``.
The first run is the one a user makes, so it is also the check of the
script as it is.  Run from the repository root on a machine with one
NVIDIA GPU:

    python3 scripts/cell_overlap.py
"""
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "results" / "cell_overlap"

#: ``chip_smoke.main()`` with the production cell started at phase 20.
AFTER = """
import sys
sys.path.insert(0, '.')
import chip_smoke as cs
start, path = cs.start_dryrun_cell, cs.dryrun_path
cs.start_dryrun_cell = lambda: None
cs.dryrun_path = lambda *a: path(*a[:-1], start())
sys.exit(cs.main())
"""

PHASE = re.compile(r"^\[(\S+)\] done in ([0-9.]+) s")


def run(name: str, cmd: list[str]) -> tuple[dict, dict]:
    """One run of ``cmd`` from the repository root, its log under OUT:
    ({phase: seconds}, {kernel: {timed field: value}})."""
    log = OUT / f"{name}.log"
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    lines = log.read_text().splitlines()
    if rc != 0:
        sys.exit(f"cell_overlap: the {name} run exited {rc}; see {log}")
    phases = {}
    for ln in lines:
        m = PHASE.match(ln)
        if m:
            phases[m.group(1)] = float(m.group(2))
    kernels = next(json.loads(ln) for ln in reversed(lines)
                   if ln.startswith('{"kernels"'))["kernels"]
    timed = {}
    for rec in kernels:
        timed[rec["name"]] = {
            k: v for k, v in rec.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and (k == "ms" or k.endswith(("_ms", "_us")))
            and not k.startswith("bound") and "bound_ms" not in k}
    print(f"[cell_overlap] {name}: exit 0, phases {phases}", flush=True)
    return phases, timed


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    beside = run("beside", [sys.executable, "chip_smoke.py"])
    after = run("after", [sys.executable, "-c", AFTER])

    def pair(a, b):
        return [a, b, a / b if b else None]

    phases = {p: pair(beside[0][p], after[0][p])
              for p in beside[0] if p in after[0]}
    fields = {}
    for name, rec in beside[1].items():
        for k, v in rec.items():
            w = after[1].get(name, {}).get(k)
            if w is not None:
                fields[f"{name}.{k}"] = pair(v, w)
    between = [r for p, (_, _, r) in phases.items()
               if p not in ("build", "dryrun") and r is not None]
    ratios = [r for _, _, r in fields.values() if r is not None]
    print(json.dumps({
        "card": smi, "phases": phases, "kernel_fields": fields,
        "median_phase_ratio": statistics.median(between),
        "median_kernel_field_ratio": statistics.median(ratios)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
