"""The port's S3 proxy over real HTTP on localhost, against the reference's.

Two proxies (two client regions) over a port VirtualStore, and two over a
reference VirtualStore, both stores on one virtual clock.  Every request is
sent to both sides; the status, the body (XML or object bytes, byte for
byte) and every header but ``Date`` must be equal.  A scripted sequence
mirrors ``tests/test_s3_proxy.py`` and the HTTP half of
``tests/test_api_surface.py`` (ranges, conditionals, pagination, delimiter,
batch delete, namespaced manifests, multipart, error mapping, 503 +
Retry-After); a seeded stream of a few hundred requests covers the same
operations in random order.  Then the lifecycle export
(``tests/test_lifecycle.py``) on the port's controller, and an FSBackend
store behind the proxy in ``tmp_path``.
"""

import http.client
import json
from urllib.parse import urlparse

import numpy as np
import pytest

from repro.core.backends import make_backends as r_make_backends
from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.lifecycle import compile_rules as r_compile_rules
from repro.core.s3_proxy import S3Proxy as RS3Proxy
from repro.core.ttl_policy import AdaptiveTTLController as RController
from repro.core.ttl_policy import EdgeTTL as REdgeTTL
from repro.core.virtual_store import VirtualStore as RVirtualStore
from repro_torch.core import (
    VirtualStore, make_backends, paper_2region_catalog, pick_regions,
)
from repro_torch.core.lifecycle import (
    LifecycleRule, compile_rules, enforce_rule_cap, fidelity_report,
    to_s3_json,
)
from repro_torch.core.s3_proxy import S3Proxy
from repro_torch.core.ttl_policy import AdaptiveTTLController, EdgeTTL

DAY = 24 * 3600.0
S3_NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _call(endpoint, method, path, data=None, headers=None):
    u = urlparse(endpoint)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        body = resp.read()
        hdrs = tuple((k, v) for k, v in resp.getheaders() if k != "Date")
        return resp.status, body, hdrs
    finally:
        conn.close()


class Twin:
    """A port and a reference store, each behind one proxy per region."""

    def __init__(self, root=None):
        self.clk = FakeClock()
        self.sides = []
        for pick, mk_be, VS, Proxy, kw, sub in (
                (pick_regions, make_backends, VirtualStore, S3Proxy,
                 {"device": "cpu"}, "port"),
                (r_pick_regions, r_make_backends, RVirtualStore, RS3Proxy,
                 {}, "ref")):
            cat = pick(3)
            be_kw = ({"root": str(root / sub)} if root is not None else {})
            be = mk_be(list(cat.region_names()), "fs" if root else "memory",
                       **be_kw)
            vs = VS(cat, be, mode="FB", clock=self.clk, **kw)
            proxies = [Proxy(vs, r).start() for r in cat.region_names()]
            self.sides.append((vs, be, proxies))
        self.regions = self.sides[0][0].cost.region_names()

    @property
    def store(self):
        return self.sides[0][0]

    def __call__(self, method, path, region=0, data=None, headers=None):
        got, want = (_call(proxies[region].endpoint, method, path, data,
                           headers)
                     for _vs, _be, proxies in self.sides)
        assert got == want, (method, path, headers)
        return got

    def stop(self):
        for _vs, _be, proxies in self.sides:
            for p in proxies:
                p.stop()


@pytest.fixture
def twin():
    t = Twin()
    yield t
    t.stop()


def _header(hdrs, name):
    return dict(hdrs).get(name)


def test_bucket_and_object_lifecycle(twin):
    assert twin("PUT", "/demo")[0] == 200
    assert b"<Name>demo</Name>" in twin("GET", "/")[1]
    st, _, hdrs = twin("PUT", "/demo/dir/obj.bin", data=b"payload" * 100)
    assert st == 200 and _header(hdrs, "x-amz-version-id") == "1"
    a, b, _ = twin.regions
    assert twin.store.replica_regions("demo", "dir/obj.bin") == [a]
    twin.clk.t = 10.0
    st, body, _ = twin("GET", "/demo/dir/obj.bin", region=1)
    assert st == 200 and body == b"payload" * 100
    assert set(twin.store.replica_regions("demo", "dir/obj.bin")) == {a, b}
    st, _, hdrs = twin("HEAD", "/demo/dir/obj.bin")
    assert st == 200 and int(_header(hdrs, "Content-Length")) == 700
    assert b"<Key>dir/obj.bin</Key>" in twin(
        "GET", "/demo?list-type=2&prefix=dir/")[1]
    twin("PUT", "/demo/copy.bin",
         headers={"x-amz-copy-source": "/demo/dir/obj.bin"})
    assert twin("GET", "/demo/copy.bin")[1] == b"payload" * 100
    assert twin("DELETE", "/demo/copy.bin")[0] == 204
    assert twin("GET", "/demo/copy.bin")[0] == 404


def test_multipart_over_the_wire(twin):
    twin("PUT", "/mpu")
    body = twin("POST", "/mpu/big?uploads")[1]
    uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    twin("PUT", f"/mpu/big?partNumber=2&uploadId={uid}", data=b"WORLD")
    twin("PUT", f"/mpu/big?partNumber=1&uploadId={uid}", data=b"HELLO ")
    assert twin("POST", f"/mpu/big?uploadId={uid}")[0] == 200
    assert twin("GET", "/mpu/big")[1] == b"HELLO WORLD"
    # With a manifest: a bad ETag is 400, a good one completes, again 404.
    body = twin("POST", "/mpu/obj?uploads")[1]
    uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    h1 = twin("PUT", f"/mpu/obj?partNumber=1&uploadId={uid}", data=b"ONE|")[2]
    h2 = twin("PUT", f"/mpu/obj?partNumber=2&uploadId={uid}", data=b"TWO")[2]
    bad = ("<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
           '<ETag>"junk"</ETag></Part></CompleteMultipartUpload>').encode()
    assert twin("POST", f"/mpu/obj?uploadId={uid}", data=bad)[0] == 400
    good = ("<CompleteMultipartUpload>"
            f"<Part><PartNumber>1</PartNumber><ETag>{_header(h1, 'ETag')}</ETag></Part>"
            f"<Part><PartNumber>2</PartNumber><ETag>{_header(h2, 'ETag')}</ETag></Part>"
            "</CompleteMultipartUpload>").encode()
    assert twin("POST", f"/mpu/obj?uploadId={uid}", data=good)[0] == 200
    assert twin("GET", "/mpu/obj")[1] == b"ONE|TWO"
    assert twin("POST", f"/mpu/obj?uploadId={uid}", data=good)[0] == 404
    # Abort.
    body = twin("POST", "/mpu/gone?uploads")[1]
    uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    twin("PUT", f"/mpu/gone?partNumber=1&uploadId={uid}", data=b"x")
    assert twin("DELETE", f"/mpu/gone?uploadId={uid}")[0] == 204
    assert twin("GET", "/mpu/gone")[0] == 404


def test_ranged_and_conditional_reads(twin):
    payload = bytes(range(256)) * 2
    twin("PUT", "/r")
    twin("PUT", "/r/k", data=payload)
    st, body, hdrs = twin("GET", "/r/k", headers={"Range": "bytes=0-15"})
    assert st == 206 and body == payload[:16]
    assert _header(hdrs, "Content-Range") == f"bytes 0-15/{len(payload)}"
    st, body, _ = twin("GET", "/r/k", headers={"Range": "bytes=-8"})
    assert st == 206 and body == payload[-8:]
    st, body, _ = twin("GET", "/r/k", region=1, headers={"Range": "bytes=4-7"})
    assert st == 206 and body == payload[4:8]
    assert twin("GET", "/r/k", headers={
        "Range": f"bytes={len(payload)}-"})[0] == 416
    etag = _header(twin("GET", "/r/k")[2], "ETag")
    st, _, hdrs = twin("GET", "/r/k", headers={"If-None-Match": etag})
    assert st == 304 and _header(hdrs, "ETag") == etag
    assert twin("HEAD", "/r/k", headers={"If-None-Match": etag})[0] == 304
    assert twin("GET", "/r/k", headers={"If-Match": '"nope"'})[0] == 412
    assert twin("GET", "/r/k", headers={"If-Match": etag})[1] == payload


def test_list_pagination_and_delimiter(twin):
    twin("PUT", "/pg")
    for i in range(45):
        twin("PUT", f"/pg/logs/{i:04d}", data=b"x")
    twin("PUT", "/pg/readme", data=b"x")
    seen, token, pages = [], None, 0
    while True:
        url = "/pg?list-type=2&prefix=logs/&max-keys=20"
        if token:
            url += f"&continuation-token={token}"
        text = twin("GET", url)[1].decode()
        seen += [s.split("</Key>")[0] for s in text.split("<Key>")[1:]]
        pages += 1
        if "<NextContinuationToken>" not in text:
            assert "<IsTruncated>false</IsTruncated>" in text
            break
        token = text.split("<NextContinuationToken>")[1].split("<")[0]
    assert pages == 3 and len(seen) == 45 and seen == sorted(seen)
    text = twin("GET", "/pg?list-type=2&delimiter=/")[1].decode()
    assert "<CommonPrefixes><Prefix>logs/</Prefix></CommonPrefixes>" in text
    assert "<Key>readme</Key>" in text and "<Key>logs/0000</Key>" not in text


def test_batch_delete_and_namespaced_manifests(twin):
    twin("PUT", "/bd")
    for i in range(3):
        twin("PUT", f"/bd/k{i}", data=b"x")
    manifest = ("<Delete>" +
                "".join(f"<Object><Key>k{i}</Key></Object>" for i in range(2)) +
                "<Object><Key>ghost</Key></Object></Delete>").encode()
    st, body, _ = twin("POST", "/bd?delete", data=manifest)
    assert st == 200 and b"<Deleted><Key>ghost</Key></Deleted>" in body
    assert twin.store.list_objects("bd") == ["k2"]
    ns = f"<Delete {S3_NS}><Object><Key>k2</Key></Object></Delete>".encode()
    assert b"<Deleted><Key>k2</Key></Deleted>" in twin(
        "POST", "/bd?delete", data=ns)[1]
    body = twin("POST", "/bd/mp?uploads")[1]
    uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    twin("PUT", f"/bd/mp?partNumber=1&uploadId={uid}", data=b"P1")
    bad = (f"<CompleteMultipartUpload {S3_NS}><Part><PartNumber>1</PartNumber>"
           '<ETag>"junk"</ETag></Part></CompleteMultipartUpload>').encode()
    assert twin("POST", f"/bd/mp?uploadId={uid}", data=bad)[0] == 400
    empty = f"<CompleteMultipartUpload {S3_NS}/>".encode()
    assert twin("POST", f"/bd/mp?uploadId={uid}", data=empty)[0] == 400


def test_error_mapping(twin):
    twin("PUT", "/dm")
    assert twin("DELETE", "/dm/nothing")[0] == 404
    twin("PUT", "/dm/k", data=b"x")
    assert twin("DELETE", "/dm")[0] == 409
    assert twin("DELETE", "/dm/k")[0] == 204
    assert twin("DELETE", "/dm")[0] == 204
    assert twin("DELETE", "/dm")[0] == 404
    twin("PUT", "/mv")
    twin("PUT", "/mv/k", data=b"x")
    assert twin("GET", "/mv?list-type=2&max-keys=abc")[0] == 400
    assert twin("GET", "/mv/k?versionId=abc")[0] == 400
    assert twin("PUT", "/mv/k2?partNumber=abc&uploadId=x")[0] == 400
    assert twin("PUT", "/mv/k2", headers={"x-amz-copy-source": "no-slash"})[0] == 400
    assert twin("GET", "/nope/k")[0] == 404


def test_503_with_retry_after_during_an_outage(twin):
    twin("PUT", "/b")
    twin("PUT", "/b/k", data=b"payload")
    for vs, _be, _p in twin.sides:
        vs.region_down(twin.regions[0])
    st, body, hdrs = twin("GET", "/b/k", region=1)
    assert st == 503 and _header(hdrs, "Retry-After") == "1"
    assert b"ServiceUnavailable" in body
    for vs, _be, _p in twin.sides:
        vs.region_up(twin.regions[0])
    assert twin("GET", "/b/k", region=1)[1] == b"payload"


def _stream(twin, seed, n):
    """A seeded stream of S3 requests from all three client regions; the
    clock moves between requests.  Returns the status codes seen."""
    rng = np.random.default_rng(seed)
    keys = [f"p{i % 2}/o{i}" for i in range(6)]
    codes, uploads, token = {}, [], None
    twin("PUT", "/s")
    for _ in range(n):
        twin.clk.t += float(rng.exponential(3 * 3600.0))
        region = int(rng.integers(0, 3))
        key = keys[int(rng.integers(0, len(keys)))]
        kind = int(rng.choice(8, p=[0.2, 0.35, 0.08, 0.1, 0.08, 0.04, 0.05,
                                    0.1]))
        if kind == 0:
            st = twin("PUT", f"/s/{key}", region,
                      data=rng.bytes(int(rng.integers(0, 2048))))[0]
        elif kind == 1:
            hdrs = {}
            if rng.random() < 0.3:
                a = int(rng.integers(0, 2100))
                hdrs["Range"] = (f"bytes={a}-{a + int(rng.integers(0, 99))}"
                                 if rng.random() < 0.7 else
                                 f"bytes=-{int(rng.integers(1, 50))}")
            if rng.random() < 0.2:
                etag = _header(twin("HEAD", f"/s/{key}", region)[2], "ETag")
                hdrs["If-None-Match" if rng.random() < 0.5
                     else "If-Match"] = etag or '"x"'
            st = twin("GET", f"/s/{key}", region, headers=hdrs)[0]
        elif kind == 2:
            st = twin("HEAD", f"/s/{key}", region)[0]
        elif kind == 3:
            url = f"/s?list-type=2&max-keys={int(rng.integers(1, 4))}"
            if rng.random() < 0.5:
                url += "&delimiter=/"
            if token and rng.random() < 0.6:
                url += f"&continuation-token={token}"
            st, body, _ = twin("GET", url, region)
            text = body.decode()
            token = (text.split("<NextContinuationToken>")[1].split("<")[0]
                     if "<NextContinuationToken>" in text else None)
        elif kind == 4:
            st = twin("DELETE", f"/s/{key}", region)[0]
        elif kind == 5:
            manifest = ("<Delete>" + "".join(
                f"<Object><Key>{keys[int(i)]}</Key></Object>"
                for i in rng.integers(0, len(keys), 2)) + "</Delete>").encode()
            st = twin("POST", "/s?delete", region, data=manifest)[0]
        elif kind == 6:
            src = keys[int(rng.integers(0, len(keys)))]
            st = twin("PUT", f"/s/{key}", region,
                      headers={"x-amz-copy-source": f"/s/{src}"})[0]
        elif uploads and rng.random() < 0.5:
            uid, ukey, uregion = uploads.pop(0)
            st = twin("POST", f"/s/{ukey}?uploadId={uid}", uregion)[0]
        else:
            body = twin("POST", f"/s/{key}?uploads", region)[1]
            uid = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
            for part in range(1, int(rng.integers(1, 3)) + 1):
                twin("PUT", f"/s/{key}?partNumber={part}&uploadId={uid}",
                     region, data=rng.bytes(int(rng.integers(1, 700))))
            uploads.append((uid, key, region))
            st = 200
        codes[st] = codes.get(st, 0) + 1
    return codes


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_request_stream_equals_the_reference(twin, seed):
    codes = _stream(twin, seed, 300)
    assert {200, 204, 206, 404} <= set(codes), codes
    (vs, be, _), (r_vs, r_be, _) = twin.sides
    assert vs.meta.backup() == r_vs.meta.backup()
    assert vs.transfers.bytes_moved == r_vs.transfers.bytes_moved
    assert ({k: e.ttl_seconds for k, e in vs.meta.ctl.edge_ttls.items()}
            == {k: e.ttl_seconds for k, e in r_vs.meta.ctl.edge_ttls.items()})


def test_fs_backends_behind_the_proxy(tmp_path):
    twin = Twin(root=tmp_path)
    try:
        twin("PUT", "/fs")
        twin("PUT", "/fs/dir/key.bin", data=b"\x00\x01" * 100)
        twin.clk.t = 60.0
        assert twin("GET", "/fs/dir/key.bin", region=2)[1] == b"\x00\x01" * 100
        port_files = sorted(p.relative_to(tmp_path / "port")
                            for p in (tmp_path / "port").rglob("*") if p.is_file())
        ref_files = sorted(p.relative_to(tmp_path / "ref")
                           for p in (tmp_path / "ref").rglob("*") if p.is_file())
        assert port_files == ref_files and len(port_files) == 2
    finally:
        twin.stop()


# ---------------------------------------------------------------------------
# Lifecycle export (tests/test_lifecycle.py), on the port's controller
# ---------------------------------------------------------------------------

def _controllers_with_ttls(ttls):
    ctl = AdaptiveTTLController(paper_2region_catalog(), device="cpu")
    r_ctl = RController(r_pick_regions(3))
    for bucket, ttl in ttls:
        ctl.edge_ttls[(bucket, "aws:us-east-1", "aws:us-west-1")] = EdgeTTL(
            ttl, chosen_at=0.0)
        r_ctl.edge_ttls[(bucket, "aws:us-east-1", "aws:us-west-1")] = REdgeTTL(
            ttl, chosen_at=0.0)
    return ctl, r_ctl


def test_compile_rounds_up_to_days_and_takes_min_edge():
    ctl, r_ctl = _controllers_with_ttls([("logs", 1.4 * DAY),
                                         ("models", 0.2 * DAY),
                                         ("logs", 3.0 * DAY)])
    for c in (ctl, r_ctl):
        c.edge_ttls[("logs", "aws:us-west-1", "aws:us-west-1x")] = type(
            next(iter(c.edge_ttls.values())))(99 * DAY, 0.0)
        c.edge_ttls[("logs", "gcp:x", "aws:us-west-1")] = type(
            next(iter(c.edge_ttls.values())))(0.9 * DAY, 0.0)
    rules = compile_rules(ctl, "aws:us-west-1")
    assert rules["logs"][0].expiration_days == 1          # min edge, ceil
    assert rules["models"][0].expiration_days == 1        # provider floor
    assert rules["models"][0].rounding_error_seconds > 0
    r_rules = r_compile_rules(r_ctl, "aws:us-west-1")
    assert ({b: [vars(r) for r in rs] for b, rs in rules.items()}
            == {b: [vars(r) for r in rs] for b, rs in r_rules.items()})


def test_rules_from_learned_ttls_equal_the_reference():
    """Rules compiled from the TTLs a port controller learned in a replay
    (CPU engine) equal the reference's compiled from its own replay."""
    from repro.core.policies import make_policy as r_make_policy
    from repro.core.simulator import Simulator as RSimulator
    from repro.core.workloads import make_workload as r_make_workload
    from repro_torch.core.replay import run_sim_plane
    from repro_torch.core.workloads import make_workload

    cat, r_cat = pick_regions(3), r_pick_regions(3)
    run = run_sim_plane(make_workload("zipfian", cat.region_names(), seed=7),
                        cat, "skystore", device="cpu")
    r_policy = r_make_policy("skystore", r_cat)
    RSimulator(r_cat, r_policy, mode="FB").run(
        r_make_workload("zipfian", r_cat.region_names(), seed=7))
    ctl = run.deciders[0].ctl
    assert ctl.n_refreshes > 0
    n_rules = 0
    for region in cat.region_names():
        got = compile_rules(ctl, region)
        want = r_compile_rules(r_policy.ctl, region)
        assert ({b: [vars(r) for r in rs] for b, rs in got.items()}
                == {b: [vars(r) for r in rs] for b, rs in want.items()})
        n_rules += sum(len(rs) for rs in got.values())
    assert n_rules > 0


def test_rule_cap_merges_toward_shorter_expiry():
    rules = [LifecycleRule(f"r{i}", f"p{i}/", i + 1, (i + 1) * DAY)
             for i in range(1500)]
    capped = enforce_rule_cap(rules, cap=1000)
    assert len(capped) == 1000
    assert min(r.expiration_days for r in capped) == 1
    assert max(r.expiration_days for r in capped) == 1500


def test_s3_json_shape_and_fidelity_report():
    doc = json.loads(to_s3_json([LifecycleRule("a", "x/", 3, 2.5 * DAY)]))
    assert doc["Rules"][0]["Expiration"]["Days"] == 3
    assert doc["Rules"][0]["Filter"]["Prefix"] == "x/"
    rep = fidelity_report([LifecycleRule("a", "x/", 1, 600.0),
                           LifecycleRule("b", "y/", 5, 4.6 * DAY)])
    assert rep["rules"] == 2 and rep["subday_ttls_lost"] == 1
    assert rep["max_rounding_s"] == pytest.approx(DAY - 600.0)
    assert fidelity_report([]) == {"rules": 0, "max_rounding_s": 0.0,
                                   "mean_rounding_s": 0.0}
