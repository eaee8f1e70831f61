"""Sweep-campaign CLI: the paper's study (Figs 3-5) and its claim gate.

  PYTHONPATH=src python -m repro_torch.launch.campaign \\
      --campaign paper-fig3 --campaign paper-fig5 --check-claims

evaluates each named campaign's cube with the SDV cycle model (numpy, no
card needed), stores it in the schema-versioned store (``--sweeps-json``,
``BENCH_sweeps.json`` by default; the reference reads it too) and prints
its records as one generic table (machine, kernel, vl, extra_latency,
bw_limit, cycles, source).  ``--check-claims`` adds ``paper-fig3`` and
``paper-fig5``, checks the paper's two claims on them and exits 1 on any
violation.  ``--measure`` also times the port's kernels on the card at
each campaign's shortest and longest VL (``core.campaign.measure_cuda``)
and prints the modeled-vs-measured table; it needs a GPU and raises
without one.

The counterpart of ``run_campaigns`` / ``_check_claims`` in the
reference's ``benchmarks/run.py``; its per-figure table emitters are not
ported.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.campaign import (
    SweepStore,
    campaign_names,
    crosscheck_measured,
    run_campaign,
)
from repro_torch.core.sweep import (
    check_bandwidth_claim,
    check_latency_claim,
    slowdown_tables,
    sweep_result_from_campaign,
)


def print_records(name: str, result) -> None:
    """The generic table of a campaign: every modeled and measured record."""
    print(f"\n# table: campaign {name} "
          "(machine,kernel,vl,extra_latency,bw_limit,cycles,source)")
    for r in result.records():
        print(f"{r['machine']},{r['kernel']},{r['vl']},{r['extra_latency']},"
              f"{r['bw_limit']},{r.get('cycles', '')},{r['source']}")


def print_crosscheck(name: str, result) -> None:
    rows = crosscheck_measured(result)
    if not rows:
        return
    print(f"\n# table: campaign {name} model-vs-measured "
          "(kernel,vl,problem,modeled_cycles,measured_us,cycles_per_us)")
    for row in rows:
        print(f"{row['kernel']},{row['vl']},{row['problem']},"
              f"{row['modeled_cycles']:.0f},"
              f"{row['measured_us']:.1f},{row['cycles_per_us']:.1f}")


def check_claims(store: SweepStore) -> list[str]:
    """The paper's two claims, evaluated from the stored fig3 / fig5 cubes."""
    fig3 = sweep_result_from_campaign(store.get("paper-fig3"))
    fig5 = sweep_result_from_campaign(store.get("paper-fig5"))
    return (check_latency_claim(slowdown_tables(fig3))
            + check_bandwidth_claim(fig5))


def run_campaigns(names, sweeps_json: str, measure: bool = False,
                  claims: bool = False) -> int:
    """Run named campaigns -> store -> tables (and optionally the claim
    gate).  Returns a process exit code (0 ok, 1 claim violations)."""
    if claims:
        # the claim gate needs both knob cubes
        names = list(dict.fromkeys(list(names) + ["paper-fig3", "paper-fig5"]))
    store = SweepStore(sweeps_json)
    for name in names:
        result = run_campaign(name, measure=measure)
        store.put(result)
        print(f"# campaign {name}: {result.spec.n_points} modeled points "
              f"({'x'.join(map(str, result.spec.shape))} cube)")
        print_records(name, result)
        if measure:
            print_crosscheck(name, result)
    store.save()
    print(f"# wrote {store.path} ({', '.join(store.names())})")
    if claims:
        violations = check_claims(store)
        if violations:
            print("# PAPER CLAIM VIOLATIONS:")
            for v in violations:
                print(f"#   {v}")
            return 1
        print("# paper claims: latency-tolerance HOLDS, "
              "bandwidth-exploitation HOLDS")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--campaign", action="append", default=None,
                    metavar="NAME", choices=campaign_names(),
                    help="run a named sweep campaign (repeatable); "
                         f"one of {campaign_names()}")
    ap.add_argument("--sweeps-json", default="BENCH_sweeps.json",
                    help="schema-versioned campaign results store")
    ap.add_argument("--check-claims", action="store_true",
                    help="validate the paper's two claims on the fig3/fig5 "
                         "cubes; exit 1 on violations")
    ap.add_argument("--measure", action="store_true",
                    help="time the port's kernels on the card at each "
                         "campaign's shortest and longest VL (needs a GPU)")
    args = ap.parse_args(argv)
    if not (args.campaign or args.check_claims):
        ap.error("name a --campaign or pass --check-claims")
    return run_campaigns(args.campaign or [], args.sweeps_json,
                         measure=args.measure, claims=args.check_claims)


if __name__ == "__main__":
    sys.exit(main())
