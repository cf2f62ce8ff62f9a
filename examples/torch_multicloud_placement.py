"""Cost-policy bake-off on the port: run the paper's §6.4 experiment shape.

``examples/multicloud_placement.py`` on ``repro_torch``: simulates a
3-cloud deployment on a synthetic IBM-profile trace and prints what each
placement policy would have paid.  The policies' kernels (SkyStore's TTL
refresh) run on ``--device``.

    PYTHONPATH=src python examples/torch_multicloud_placement.py --trace T65 --kind B
    PYTHONPATH=src python examples/torch_multicloud_placement.py --device cpu
"""

import argparse

from repro_torch.core import (
    assign_workload, generate_trace, pick_regions, run_policy,
)
from repro_torch.core.traces import TRACE_NAMES, WORKLOAD_KINDS

ap = argparse.ArgumentParser()
ap.add_argument("--trace", choices=TRACE_NAMES, default="T65")
ap.add_argument("--kind", choices=WORKLOAD_KINDS, default="B",
                help="A=uniform B=region-aware C=aggregation D=replication")
ap.add_argument("--regions", type=int, choices=(3, 6, 9), default=3)
ap.add_argument("--objects", type=int, default=80)
ap.add_argument("--months", type=float, default=18.0)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cat = pick_regions(args.regions)
base = generate_trace(args.trace, seed=0, n_objects=args.objects,
                      months=args.months)
trace = assign_workload(base, cat.region_names(), args.kind)
st = trace.stats()
print(f"trace {args.trace}/{args.kind}: {st['events']} events, "
      f"{st['objects']} objects, {st['bytes_put']/2**30:.1f} GiB put, "
      f"{st['months']:.1f} months, {args.regions} regions\n")

rows = []
for policy in ("always_evict", "always_store", "t_even", "ttl_cc", "ewma",
               "juicefs", "spanstore", "skystore", "cgp"):
    mode = "FP" if policy == "spanstore" else "FB"
    rep = run_policy(trace, cat, policy, mode=mode, device=args.device)
    rows.append((policy, rep.policy_cost, rep.storage, rep.network,
                 rep.n_hit / max(rep.n_get, 1)))

sky = dict((r[0], r[1]) for r in rows)["skystore"]
print(f"{'policy':14s} {'total $':>10s} {'storage $':>10s} {'egress $':>10s} "
      f"{'hit rate':>9s} {'vs skystore':>12s}")
for name, total, stor, net, hit in sorted(rows, key=lambda r: r[1]):
    print(f"{name:14s} {total:10.4f} {stor:10.4f} {net:10.4f} {hit:9.2f} "
          f"{total / sky:11.2f}x")
