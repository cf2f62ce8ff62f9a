"""S3 wire-protocol demo (paper §4.3) on the port: start two regional proxies
over one virtual store and drive the full op surface with plain HTTP -- any S3 SDK
pointed at these endpoints would work the same way.  The proxy is a pure
codec over the typed ObjectStoreAPI layer, so everything below (ranged GET,
paginated ListObjectsV2, conditional GET, batch delete) is served by the same
dispatch path the cost simulator replays.  ``examples/s3_proxy_demo.py`` on
``repro_torch``; the store's controllers refresh on ``--device``.

    PYTHONPATH=src python examples/torch_s3_proxy_demo.py               # the card
    PYTHONPATH=src python examples/torch_s3_proxy_demo.py --device cpu
"""

import argparse
import urllib.error
import urllib.request

from repro_torch.core import VirtualStore, make_backends, pick_regions
from repro_torch.core.s3_proxy import S3Proxy

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()


def req(method, url, data=None, headers=None):
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    with urllib.request.urlopen(r, timeout=10) as resp:
        return resp.status, resp.read(), dict(resp.headers)


cat = pick_regions(3)
store = VirtualStore(cat, make_backends(list(cat.region_names()), "memory"),
                     mode="FB", device=args.device)
aws, azure, gcp = cat.region_names()
pa = S3Proxy(store, aws).start()
pg = S3Proxy(store, gcp).start()
print(f"proxy in {aws}:  {pa.endpoint}")
print(f"proxy in {gcp}:  {pg.endpoint}\n")

req("PUT", f"{pa.endpoint}/artifacts")
st, _, hdrs = req("PUT", f"{pa.endpoint}/artifacts/model/ckpt-000100.npz",
                  data=b"\x93NUMPY" + b"\x00" * 4096)
etag = hdrs["ETag"]
print("PUT via aws proxy ->", st,
      "| replicas:", store.replica_regions("artifacts", "model/ckpt-000100.npz"))

st, body, _ = req("GET", f"{pg.endpoint}/artifacts/model/ckpt-000100.npz")
print("GET via gcp proxy ->", st, f"({len(body)} bytes)",
      "| replicas:", store.replica_regions("artifacts", "model/ckpt-000100.npz"))
print(f"egress charged: ${store.transfers.dollars:.9f}")

# ranged GET: just the numpy magic, served from the local gcp replica now
st, body, hdrs = req("GET", f"{pg.endpoint}/artifacts/model/ckpt-000100.npz",
                     headers={"Range": "bytes=0-5"})
print(f"ranged GET -> {st} {body!r} | {hdrs['Content-Range']}")

# conditional GET: the client-side cache revalidation path
try:
    req("GET", f"{pg.endpoint}/artifacts/model/ckpt-000100.npz",
        headers={"If-None-Match": etag})
except urllib.error.HTTPError as e:
    print("conditional GET ->", e.code, "(replica unchanged, no bytes moved)")

# paginated ListObjectsV2 with a continuation token
for i in range(5):
    req("PUT", f"{pa.endpoint}/artifacts/shard/{i:03d}", data=b"x" * 128)
st, body, _ = req("GET", f"{pa.endpoint}/artifacts?list-type=2&max-keys=3")
token = body.decode().split("<NextContinuationToken>")[1].split("<")[0]
print("LIST page 1 keys:", body.decode().count("<Key>"), "| token:",
      token[:16], "...")
st, body, _ = req("GET", f"{pa.endpoint}/artifacts?list-type=2&max-keys=3"
                         f"&continuation-token={token}")
print("LIST page 2 keys:", body.decode().count("<Key>"))

# batch delete the shards in one wire round trip
manifest = ("<Delete>" + "".join(
    f"<Object><Key>shard/{i:03d}</Key></Object>" for i in range(5)) +
    "</Delete>").encode()
st, body, _ = req("POST", f"{pa.endpoint}/artifacts?delete", data=manifest)
print("batch DELETE ->", st, "| deleted:", body.decode().count("<Deleted>"))

pa.stop(); pg.stop()
print("\nproxies stopped (stateless: restart anywhere, the store is the truth)")
