"""Quickstart: the SkyStore virtual object store in 60 lines, on the port.

``examples/quickstart.py`` on ``repro_torch``: creates a 3-cloud deployment
(in-memory region backends), writes objects write-local, reads them
cross-cloud (replicate-on-read + adaptive TTL, the TTL refreshes on the
TTL-scan kernel of ``--device``), runs the eviction scan, and prints the
money.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

from repro_torch.core import VirtualStore, make_backends, pick_regions

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cat = pick_regions(3)
aws, azure, gcp = cat.region_names()
print("regions:", cat.region_names())
print(f"T_even(aws->gcp) = {cat.t_even_months(aws, gcp):.2f} months "
      f"(egress ${cat.egress_price(aws, gcp)}/GB / storage "
      f"${cat.storage_price(gcp)}/GB/mo)")

store = VirtualStore(cat, make_backends(list(cat.region_names()), "memory"),
                     mode="FB", device=args.device)
store.create_bucket("demo")

# 1. write-local: the PUT lands in the writer's region, nothing else moves
store.put_object("demo", "dataset/shard0", b"tokens" * 1000, aws)
print("\nafter PUT:      replicas =", store.replica_regions("demo", "dataset/shard0"))

# 2. a reader in another cloud: served from the cheapest source, then
#    replicated locally with an adaptive TTL
data = store.get_object("demo", "dataset/shard0", gcp)
print("after GET@gcp:  replicas =", store.replica_regions("demo", "dataset/shard0"))
print(f"egress paid so far: ${store.transfers.dollars:.9f}")

# 3. re-reads are local (free) and keep refreshing the TTL
for _ in range(3):
    store.get_object("demo", "dataset/shard0", gcp)
print(f"after 3 re-reads:   ${store.transfers.dollars:.9f} (unchanged)")

# 4. versioning + last-writer-wins
store.put_object("demo", "dataset/shard0", b"v2" * 1000, azure)
print("\nafter overwrite@azure: replicas =",
      store.replica_regions("demo", "dataset/shard0"))
assert store.get_object("demo", "dataset/shard0", aws) == b"v2" * 1000

# 5. the background eviction scan (the §4.2 daily job)
evicted = store.run_eviction_scan()
print(f"eviction scan removed {evicted} expired replicas")

# 6. control-plane fault tolerance: back the metadata up INTO the store,
#    then recover a fresh server from it
store.backup_metadata("demo", azure)
recovered = VirtualStore.recover(cat, store.backends, "demo", azure,
                                 device=args.device)
assert recovered.get_object("demo", "dataset/shard0", gcp) == b"v2" * 1000
print("metadata backup/recover: OK")
