"""The port's VirtualStore / MetadataServer against the reference's.

Seeded op streams go through both packages' ``VirtualStore.dispatch`` with
one injected virtual clock: every operation of the §4.3 surface -- bucket
create/delete/list, PUT, GET (ranged 206 and unsatisfiable 416, If-Match
412, If-None-Match 304), HEAD, paginated LIST with and without a delimiter,
DELETE, batch delete, copy, multipart upload completed (with and without a
part manifest, with bad manifests) and aborted -- plus eviction scans.
Every response (or ``ApiError`` code, status and message) must be equal,
and at the end the metadata tables (the §4.5 backup blob, byte for byte),
the backends' bytes, the transfer log, the TTL controllers' edge TTLs and
the ledgers' ``CostReport`` s.  Streams run without a policy (the store's
own adaptive-TTL controller) and under SkyStore and always_store policies.

Then the cases of ``tests/test_metadata_store.py``,
``tests/test_list_index.py``, ``tests/test_api_surface.py``'s dispatch
level and ``tests/test_system.py``, on the port (``device="cpu"``).
"""

import dataclasses

import numpy as np
import pytest

import repro.core.api as r_api
from repro.core.backends import make_backends as r_make_backends
from repro.core.costmodel import pick_regions as r_pick_regions
from repro.core.ledger import CostLedger as RCostLedger
from repro.core.metadata import MetadataServer as RMetadataServer
from repro.core.policies import make_policy as r_make_policy
from repro.core.virtual_store import VirtualStore as RVirtualStore
import repro_torch.core.api as api
from repro_torch.core import (
    MetadataServer, VirtualStore, assign_two_region, generate_trace,
    make_backends, paper_2region_catalog, pick_regions, run_policy,
)
from repro_torch.core.api import (
    ApiError, CompleteMultipartRequest, CopyRequest, CreateMultipartRequest,
    DeleteObjectsRequest, GetRequest, ListRequest, ObjectStoreAPI,
    PutRequest, UploadPartRequest,
)
from repro_torch.core.backends import InMemoryBackend
from repro_torch.core.ledger import CostLedger
from repro_torch.core.metadata import COMMITTED
from repro_torch.core.policies import make_policy
from repro_torch.core.simulator import Simulator
from repro_torch.core.virtual_store import MPU_PREFIX

DAY = 24 * 3600.0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# Seeded op streams, both packages, one clock
# ---------------------------------------------------------------------------

def _stores(policy, clk):
    """The port's and the reference's store over the same catalog, clock,
    mode and (optional) policy, each with a CostLedger."""
    out = []
    for pick, mk_be, VS, MS, led_cls, mk_pol, kw in (
            (pick_regions, make_backends, VirtualStore, MetadataServer,
             CostLedger, make_policy, {"device": "cpu"}),
            (r_pick_regions, r_make_backends, RVirtualStore, RMetadataServer,
             RCostLedger, r_make_policy, {})):
        cat = pick(3)
        be = mk_be(list(cat.region_names()), "memory")
        ledger = led_cls(cat, policy=policy or "live", mode="FB")
        if policy is None:
            vs = VS(cat, be, mode="FB", clock=clk, ledger=ledger, **kw)
        else:
            pol = mk_pol(policy, cat, **kw)
            meta = MS(cat, mode="FB", versioning=False, ledger=ledger, **kw)
            vs = VS(cat, be, meta, mode="FB", clock=clk, policy=pol,
                    ledger=ledger, **kw)
        out.append(vs)
    return out


def _run(vs, module, name, kwargs):
    """Dispatch one request built from ``module``'s classes; the response as
    plain data, or the error as (code, status, message)."""
    try:
        resp = vs.dispatch(getattr(module, name)(**kwargs))
    except Exception as e:   # an ApiError of either package
        assert hasattr(e, "code"), repr(e)
        return ("error", e.code, e.http_status, str(e))
    return (type(resp).__name__, dataclasses.asdict(resp))


def _ranges(rng, size):
    choice = int(rng.integers(0, 12))
    if choice == 1:
        a = int(rng.integers(0, max(size, 1)))
        return a, a + int(rng.integers(0, 64))
    if choice == 2:
        return None, int(rng.integers(1, 80))
    if choice == 3:
        return int(rng.integers(0, max(size, 1))), None
    if choice == 4:
        return size + int(rng.integers(0, 5)), None         # 416
    return None


def _drive(seed, policy, n_ops):
    """Run a seeded stream through both stores; returns (port, reference,
    how many responses of each kind were compared)."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    vs, r_vs = _stores(policy, clk)
    regions = vs.cost.region_names()
    keys = [f"d{i % 3}/k{i}" for i in range(8)] + ["top"]
    buckets = ["b0", "b1"]
    etags, sizes, tokens, uploads = {}, {}, {}, []
    seen = {}

    def both(name, **kwargs):
        got = _run(vs, api, name, kwargs)
        want = _run(r_vs, r_api, name, kwargs)
        assert got == want, (name, kwargs)
        tag = got[1] if got[0] == "error" else name
        seen[tag] = seen.get(tag, 0) + 1
        return got

    for b in buckets:
        both("CreateBucketRequest", bucket=b)
    kinds = ["put", "get", "head", "list", "delete", "delete_many", "copy",
             "mpu", "bucket", "scan"]
    probs = [0.17, 0.50, 0.05, 0.07, 0.03, 0.02, 0.05, 0.05, 0.02, 0.04]
    for _ in range(n_ops):
        clk.t += float(rng.exponential(2 * 3600.0))
        kind = kinds[int(rng.choice(len(kinds), p=probs))]
        bucket = buckets[int(rng.random() < 0.2)]
        key = keys[int(rng.integers(0, len(keys)))]
        region = regions[int(rng.integers(0, len(regions)))]
        if kind == "put":
            body = rng.bytes(int(rng.integers(0, 3000)))
            got = both("PutRequest", bucket=bucket, key=key, region=region,
                       body=body)
            if got[0] == "PutResponse":
                etags[(bucket, key)], sizes[(bucket, key)] = got[1]["etag"], len(body)
        elif kind == "get":
            etag = etags.get((bucket, key), "nope")
            cond = int(rng.integers(0, 14))
            both("GetRequest", bucket=bucket, key=key, region=region,
                 range_=_ranges(rng, sizes.get((bucket, key), 0)),
                 if_match=(f'"{etag}"' if cond == 1 else
                           '"other"' if cond == 2 else None),
                 if_none_match=(f'"{etag}"' if cond == 3 else
                                "*" if cond == 4 else None))
        elif kind == "head":
            etag = etags.get((bucket, key), "nope")
            both("HeadRequest", bucket=bucket, key=key, region=region,
                 if_none_match=f'"{etag}"' if rng.random() < 0.3 else None)
        elif kind == "list":
            got = both("ListRequest", bucket=bucket,
                       prefix=["", "d1/", "d", "t"][int(rng.integers(0, 4))],
                       max_keys=int(rng.integers(1, 5)),
                       continuation_token=(tokens.get(bucket)
                                           if rng.random() < 0.6 else None),
                       delimiter="/" if rng.random() < 0.5 else None,
                       region=region)
            if got[0] == "ListResponse":
                tokens[bucket] = got[1]["next_continuation_token"]
        elif kind == "delete":
            both("DeleteObjectRequest", bucket=bucket, key=key, region=region)
        elif kind == "delete_many":
            both("DeleteObjectsRequest", bucket=bucket,
                 keys=[keys[int(i)] for i in rng.integers(0, len(keys), 3)],
                 region=region)
        elif kind == "copy":
            both("CopyRequest", bucket=bucket, src_key=key,
                 dst_key=keys[int(rng.integers(0, len(keys)))], region=region)
        elif kind == "mpu":
            if uploads and rng.random() < 0.6:
                uid, ub, uk, ur, parts = uploads.pop(0)
                end = int(rng.integers(0, 4))
                if end == 0:
                    both("AbortMultipartRequest", upload_id=uid)
                    continue
                manifest = (None if end == 1 else list(parts) if end == 2
                            else [(n, "junk") for n, _e in parts])
                got = both("CompleteMultipartRequest", bucket=ub, key=uk,
                           region=ur, upload_id=uid, parts=manifest)
                if got[0] == "CompleteMultipartResponse":
                    etags[(ub, uk)] = got[1]["etag"]
                    sizes[(ub, uk)] = got[1]["size"]
                elif got[0] == "error" and got[1] == "InvalidPart":
                    uploads.append((uid, ub, uk, ur, parts))
            else:
                got = both("CreateMultipartRequest", bucket=bucket, key=key,
                           region=region)
                if got[0] == "CreateMultipartResponse":
                    uid, parts = got[1]["upload_id"], []
                    for n in range(1, int(rng.integers(1, 4)) + 1):
                        up = both("UploadPartRequest", upload_id=uid,
                                  part_number=n,
                                  body=rng.bytes(int(rng.integers(1, 900))))
                        parts.append((n, up[1]["etag"]))
                    uploads.append((uid, bucket, key, region, parts))
        elif kind == "bucket":
            which = int(rng.integers(0, 3))
            if which == 0:
                both("ListBucketsRequest")
            elif which == 1:
                both("CreateBucketRequest", bucket="b2")
            else:
                both("DeleteBucketRequest", bucket=buckets[1])
        else:
            assert vs.run_eviction_scan(clk.t) == r_vs.run_eviction_scan(clk.t)
            seen["scan"] = seen.get("scan", 0) + 1
    return vs, r_vs, seen, clk


def _backend_state(vs):
    return {r: {k: (data, dataclasses.astuple(h))
                for k, (data, h) in sorted(be._data.items())}
            for r, be in vs.backends.items()}


def _controller(vs):
    """The controller that took the store's TTL decisions."""
    return getattr(vs.policy, "ctl", None) or vs.meta.ctl


STREAMS = [(seed, policy) for seed in (0, 1, 2)
           for policy in (None, "skystore", "always_store")]


@pytest.mark.parametrize("seed,policy", STREAMS,
                         ids=[f"{s}-{p or 'no_policy'}" for s, p in STREAMS])
def test_op_stream_matches_the_reference(seed, policy):
    vs, r_vs, seen, clk = _drive(seed, policy, 700)
    # Every operation kind of the surface was exercised, with its errors.
    for tag in ("PutRequest", "GetRequest", "HeadRequest", "ListRequest",
                "DeleteObjectRequest", "DeleteObjectsRequest", "CopyRequest",
                "CreateMultipartRequest", "UploadPartRequest",
                "CompleteMultipartRequest", "NoSuchKey", "InvalidRange",
                "PreconditionFailed", "NotModified", "InvalidPart", "scan"):
        assert seen.get(tag, 0) > 0, (tag, seen)
    assert vs.meta.backup() == r_vs.meta.backup()
    assert _backend_state(vs) == _backend_state(r_vs)
    assert vs.transfers.bytes_moved == r_vs.transfers.bytes_moved
    assert vs.transfers.dollars == r_vs.transfers.dollars
    ctl, r_ctl = _controller(vs), _controller(r_vs)
    if policy in (None, "skystore"):
        assert ctl.n_refreshes > 0            # the TTL decisions were taken
        assert ctl.device.type == "cpu"
    assert ({k: e.ttl_seconds for k, e in ctl.edge_ttls.items()}
            == {k: e.ttl_seconds for k, e in r_ctl.edge_ttls.items()})
    rep = vs.ledger.finalize(clk.t, vs.meta)
    r_rep = r_vs.ledger.finalize(clk.t, r_vs.meta)
    assert rep.components() == r_rep.components()
    assert rep.counters() == r_rep.counters()
    assert rep.n_get > 100


# ---------------------------------------------------------------------------
# tests/test_metadata_store.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def setup():
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "memory")
    vs = VirtualStore(cat, be, mode="FB", device="cpu")
    vs.create_bucket("b")
    return cat, be, vs


def test_two_phase_commit_visibility(setup):
    cat, _be, vs = setup
    ms = vs.meta
    r = cat.region_names()[0]
    v = ms.begin_upload("b", "k", r, 10, now=0.0)
    with pytest.raises(KeyError):
        ms.locate("b", "k", r, now=1.0)
    ms.complete_upload("b", "k", r, v, 10, "etag", now=2.0)
    vm, src, hit = ms.locate("b", "k", r, now=3.0)
    assert hit and src == r and vm.version == 1


def test_pending_timeout_rolls_back(setup):
    cat, _be, vs = setup
    ms = vs.meta
    r = cat.region_names()[0]
    ms.begin_upload("b", "gone", r, 10, now=0.0)
    assert len(ms.expire_pending(now=ms.pending_timeout + 1.0)) == 1
    with pytest.raises(KeyError):
        ms.complete_upload("b", "gone", r, 1, 10, "e", now=400.0)


def test_put_get_versioning_and_lww(setup):
    cat, _be, vs = setup
    a, b, c = cat.region_names()
    assert vs.put_object("b", "k", b"v1", a) == 1
    assert vs.put_object("b", "k", b"v2-longer", b) == 2
    assert vs.get_object("b", "k", c) == b"v2-longer"
    assert vs.head_object("b", "k").size == len(b"v2-longer")


def test_replicate_on_read_and_eviction_scan(setup):
    cat, _be, vs = setup
    a, b, _ = cat.region_names()
    vs.put_object("b", "k", b"x" * 64, a)
    vs.get_object("b", "k", b)
    assert set(vs.replica_regions("b", "k")) == {a, b}
    rep = vs.meta.head_object("b", "k").latest.replicas[b]
    rep.ttl = 1.0
    rep.last_access = 0.0
    assert vs.run_eviction_scan(now=1e9) == 1
    assert vs.replica_regions("b", "k") == [a]      # base survives (pinned)
    assert vs.get_object("b", "k", b) == b"x" * 64


def test_copy_list_delete(setup):
    cat, _be, vs = setup
    a = cat.region_names()[0]
    vs.put_object("b", "k1", b"data", a)
    vs.copy_object("b", "k1", "k2", a)
    assert vs.list_objects("b") == ["k1", "k2"]
    vs.delete_object("b", "k1")
    assert vs.list_objects("b") == ["k2"]
    with pytest.raises(KeyError):
        vs.get_object("b", "k1", a)


def test_multipart_upload(setup):
    cat, _be, vs = setup
    a = cat.region_names()[0]
    uid = vs.create_multipart_upload("b", "mpu", a)
    vs.upload_part(uid, 2, b"WORLD")
    vs.upload_part(uid, 1, b"HELLO ")
    vs.complete_multipart_upload("b", "mpu", a, uid)
    assert vs.get_object("b", "mpu", a) == b"HELLO WORLD"


def test_metadata_backup_restore_reconcile(setup):
    cat, be, vs = setup
    a, b, _ = cat.region_names()
    vs.put_object("b", "k", b"payload", a)
    vs.backup_metadata("b", a)
    vs2 = VirtualStore.recover(cat, be, "b", a, device="cpu")
    assert vs2.get_object("b", "k", b) == b"payload"
    assert vs2.meta.ctl.device.type == "cpu"
    ms3 = MetadataServer(cat, mode="FB", device="cpu")
    ms3.create_bucket("b")
    assert ms3.reconcile(be) >= 1


def test_fs_backend_roundtrip(tmp_path):
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "fs", root=str(tmp_path))
    vs = VirtualStore(cat, be, mode="FB", device="cpu")
    vs.create_bucket("b")
    vs.put_object("b", "dir/key.bin", b"\x00\x01" * 100, cat.region_names()[0])
    assert vs.get_object("b", "dir/key.bin",
                         cat.region_names()[2]) == b"\x00\x01" * 100
    assert len(list(be[cat.region_names()[2]].list("b"))) == 1


# ---------------------------------------------------------------------------
# tests/test_list_index.py, on the port
# ---------------------------------------------------------------------------

N_KEYS = 5200


@pytest.fixture(scope="module")
def big_store():
    cat = pick_regions(3)
    meta = MetadataServer(cat, mode="FB", device="cpu")
    store = VirtualStore(cat, {r: InMemoryBackend(r) for r in cat.region_names()},
                         meta, mode="FB", device="cpu")
    store.create_bucket("big")
    region = cat.region_names()[0]
    rng = np.random.default_rng(0)
    keys = [f"pre{int(rng.integers(0, 10))}/obj-{i:06d}" for i in range(N_KEYS)]
    for i, k in enumerate(keys):
        v = meta.begin_upload("big", k, region, 8, now=float(i))
        meta.complete_upload("big", k, region, v, 8, f"e{i}", now=float(i))
    return store, meta, sorted(keys)


def _paginate(store, prefix="", max_keys=1000):
    token, pages, tokens = None, [], []
    while True:
        r = store.dispatch(ListRequest("big", prefix=prefix, max_keys=max_keys,
                                       continuation_token=token))
        pages.append([s.key for s in r.contents])
        if not r.is_truncated:
            return pages, tokens
        tokens.append(r.next_continuation_token)
        token = r.next_continuation_token


def test_pagination_covers_5k_keys_in_order(big_store):
    store, _meta, keys = big_store
    pages, tokens = _paginate(store)
    assert [k for page in pages for k in page] == keys
    assert len(pages) == (N_KEYS + 999) // 1000
    assert len(tokens) == len(pages) - 1


def test_tokens_are_stable(big_store):
    store, _meta, _keys = big_store
    _pages1, tokens1 = _paginate(store)
    _pages2, tokens2 = _paginate(store)
    assert tokens1 == tokens2
    a = store.dispatch(ListRequest("big", continuation_token=tokens1[1]))
    b = store.dispatch(ListRequest("big", continuation_token=tokens1[1]))
    assert [s.key for s in a.contents] == [s.key for s in b.contents]


def test_tokens_survive_unrelated_mutations(big_store):
    store, meta, keys = big_store
    _pages, tokens = _paginate(store)
    before = store.dispatch(ListRequest("big", continuation_token=tokens[2]))
    region = store.cost.region_names()[0]
    v = meta.begin_upload("big", "aaa-new-key", region, 8, now=1e6)
    meta.complete_upload("big", "aaa-new-key", region, v, 8, "e", now=1e6)
    meta.delete_object("big", keys[0])
    after = store.dispatch(ListRequest("big", continuation_token=tokens[2]))
    assert [s.key for s in before.contents] == [s.key for s in after.contents]
    meta.delete_object("big", "aaa-new-key")
    v = meta.begin_upload("big", keys[0], region, 8, now=1e6)
    meta.complete_upload("big", keys[0], region, v, 8, "e0", now=1e6)


def test_prefix_listing_matches_naive_filter(big_store):
    _store, meta, keys = big_store
    for prefix in ("pre3/", "pre3/obj-0001", "", "nope/"):
        assert ([om.key for om in meta.list_objects("big", prefix)]
                == [k for k in keys if k.startswith(prefix)])


def test_index_tracks_put_and_delete():
    cat = pick_regions(3)
    meta = MetadataServer(cat, mode="FB", device="cpu")
    meta.create_bucket("b")
    r = cat.region_names()[0]
    for k in ("m", "a", "z", "k"):
        v = meta.begin_upload("b", k, r, 1, now=0.0)
        meta.complete_upload("b", k, r, v, 1, "e", now=0.0)
    assert [om.key for om in meta.list_objects("b")] == ["a", "k", "m", "z"]
    meta.delete_object("b", "k")
    assert [om.key for om in meta.list_objects("b")] == ["a", "m", "z"]
    for k in ("a", "m", "z"):
        meta.delete_object("b", k)
    meta.delete_bucket("b")
    assert "b" not in meta.buckets


# ---------------------------------------------------------------------------
# tests/test_api_surface.py (dispatch level), on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def store():
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "memory")
    clk = FakeClock()
    vs = VirtualStore(cat, be, mode="FB", clock=clk, device="cpu")
    vs.create_bucket("b")
    return cat, be, vs, clk


def test_api_error_codes_are_the_reference_codes():
    assert api.ERROR_STATUS == r_api.ERROR_STATUS
    for code in api.ERROR_STATUS:
        e, r_e = api.ApiError(code, "m"), r_api.ApiError(code, "m")
        assert type(e).__name__ == type(r_e).__name__
        assert (e.http_status, str(e)) == (r_e.http_status, str(r_e))
        assert ({b.__name__ for b in type(e).__mro__}
                == {b.__name__ for b in type(r_e).__mro__})
    assert {n for n in dir(r_api) if not n.startswith("_")} <= set(dir(api))


def test_wire_helpers_equal_the_reference():
    for header in ("bytes=0-99", "bytes=100-", "bytes=-5", "bytes=-",
                   "bites=0-1", "bytes=5-2", " bytes=3-3 "):
        got = want = None
        try:
            got = api.parse_range_header(header)
        except ApiError as e:
            got = e.code
        try:
            want = r_api.parse_range_header(header)
        except r_api.ApiError as e:
            want = e.code
        assert got == want, header
    for rng_, size in (((0, 99), 50), ((None, 5), 100), ((10, None), 100),
                       (None, 100), ((100, None), 100), ((None, 0), 10),
                       ((None, 3), 0)):
        out = []
        for mod in (api, r_api):
            try:
                out.append(mod.resolve_range(rng_, size))
            except Exception as e:
                out.append((e.code, e.http_status))
        assert out[0] == out[1], (rng_, size)
    for etag, header in (("abc", '"abc"'), ("abc", 'W/"abc"'), ("abc", "*"),
                         ("abc", '"x", "abc"'), ("abc", '"abd"')):
        assert api.etag_matches(etag, header) == r_api.etag_matches(etag, header)
    for last in ("", "k", "dir/ü", "a" * 300):
        tok = api.encode_continuation_token(last)
        assert tok == r_api.encode_continuation_token(last)
        assert api.decode_continuation_token(tok) == last
    for bad in ("a", "YWJj=", "%%%"):
        out = []
        for mod in (api, r_api):
            try:
                out.append(mod.decode_continuation_token(bad))
            except Exception as e:
                out.append(e.code)
        assert out[0] == out[1], bad
    with pytest.raises(ApiError) as ei:
        api.decode_continuation_token("a")
    assert ei.value.code == "InvalidArgument"


def test_dispatch_ranged_get_local_and_remote(store):
    cat, be, vs, _clk = store
    a, b, _ = cat.region_names()
    payload = bytes(range(256)) * 4
    vs.put_object("b", "k", payload, a)
    r = vs.dispatch(GetRequest("b", "k", a, range_=(16, 31)))
    assert r.body == payload[16:32]
    assert r.content_range == (16, 31, 1024) and r.size == 1024
    assert vs.dispatch(GetRequest("b", "k", a, range_=(None, 10))).body == payload[-10:]
    r = vs.dispatch(GetRequest("b", "k", b, range_=(0, 3)))
    assert r.body == payload[:4] and not r.hit
    assert set(vs.replica_regions("b", "k")) == {a, b}
    assert be[b].get("b", "k@v1") == payload


def test_dispatch_conditional_get(store):
    cat, _be, vs, _clk = store
    a = cat.region_names()[0]
    vs.put_object("b", "k", b"hello", a)
    etag = vs.head_object("b", "k").etag
    with pytest.raises(ApiError) as ei:
        vs.dispatch(GetRequest("b", "k", a, if_none_match=f'"{etag}"'))
    assert ei.value.code == "NotModified" and ei.value.http_status == 304
    assert ei.value.etag == etag
    with pytest.raises(ApiError) as ei:
        vs.dispatch(GetRequest("b", "k", a, if_match='"different"'))
    assert ei.value.code == "PreconditionFailed" and ei.value.http_status == 412
    assert vs.dispatch(GetRequest("b", "k", a, if_match=f'"{etag}"')).body == b"hello"


def test_list_pagination_over_1k_keys(store):
    cat, _be, vs, _clk = store
    a = cat.region_names()[0]
    for i in range(1200):
        vs.put_object("b", f"obj/{i:05d}", b"x", a)
    r1 = vs.dispatch(ListRequest("b", prefix="obj/"))
    assert len(r1.contents) == 1000 and r1.is_truncated
    r2 = vs.dispatch(ListRequest("b", prefix="obj/",
                                 continuation_token=r1.next_continuation_token))
    assert len(r2.contents) == 200 and not r2.is_truncated
    assert r2.next_continuation_token is None
    keys = [s.key for s in r1.contents] + [s.key for s in r2.contents]
    assert keys == sorted(keys) and len(set(keys)) == 1200
    assert len(vs.list_objects("b", "obj/")) == 1200


def test_list_delimiter_common_prefixes(store):
    cat, _be, vs, _clk = store
    a = cat.region_names()[0]
    for k in ("dir1/a", "dir1/b", "dir2/c", "top"):
        vs.put_object("b", k, b"x", a)
    r = vs.dispatch(ListRequest("b", delimiter="/"))
    assert [s.key for s in r.contents] == ["top"]
    assert r.common_prefixes == ["dir1/", "dir2/"] and r.key_count == 3
    r1 = vs.dispatch(ListRequest("b", delimiter="/", max_keys=2))
    assert r1.is_truncated and r1.key_count == 2
    r2 = vs.dispatch(ListRequest("b", delimiter="/", max_keys=2,
                                 continuation_token=r1.next_continuation_token))
    names = ([s.key for s in r1.contents] + r1.common_prefixes +
             [s.key for s in r2.contents] + r2.common_prefixes)
    assert sorted(names) == ["dir1/", "dir2/", "top"]
    with pytest.raises(ApiError) as ei:
        vs.dispatch(ListRequest("nope"))
    assert ei.value.code == "NoSuchBucket"


def test_dispatch_batch_delete(store):
    cat, be, vs, _clk = store
    a = cat.region_names()[0]
    for i in range(4):
        vs.put_object("b", f"d/{i}", b"x", a)
    r = vs.dispatch(DeleteObjectsRequest("b", ["d/0", "d/2", "missing"]))
    assert set(r.deleted) == {"d/0", "d/2", "missing"} and r.errors == []
    assert vs.list_objects("b", "d/") == ["d/1", "d/3"]
    assert not be[a].exists("b", "d/0@v1")
    with pytest.raises(ApiError) as ei:
        vs.delete_object("b", "never-was")
    assert ei.value.code == "NoSuchKey" and ei.value.http_status == 404


def test_multipart_spills_parts_and_validates_manifests(store):
    cat, be, vs, _clk = store
    a = cat.region_names()[0]
    uid = vs.dispatch(CreateMultipartRequest("b", "big", a)).upload_id
    e1 = vs.dispatch(UploadPartRequest(uid, 1, b"HELLO ")).etag
    e2 = vs.dispatch(UploadPartRequest(uid, 2, b"WORLD")).etag
    assert len([h.key for h in be[a].list("b", MPU_PREFIX)]) == 2
    assert vs._mpu[uid].parts[1] == (e1, 6)
    for parts, code in (([(1, e1), (3, "beef")], "InvalidPart"),
                        ([(1, "wrong")], "InvalidPart"),
                        ([(1, e1), (1, e1)], "InvalidPartOrder")):
        with pytest.raises(ApiError) as ei:
            vs.dispatch(CompleteMultipartRequest("b", "big", a, uid, parts=parts))
        assert ei.value.code == code
    with pytest.raises(ApiError) as ei:
        vs.dispatch(CompleteMultipartRequest("b", "big", a, "bogus"))
    assert ei.value.code == "NoSuchUpload"
    r = vs.dispatch(CompleteMultipartRequest("b", "big", a, uid,
                                             parts=[(1, e1), (2, e2)]))
    assert r.size == 11 and vs.get_object("b", "big", a) == b"HELLO WORLD"
    assert [h.key for h in be[a].list("b", MPU_PREFIX)] == [] and uid not in vs._mpu


def test_copy_short_circuits_on_committed_local_replica(store):
    cat, _be, vs, clk = store
    a, b, _ = cat.region_names()
    vs.put_object("b", "src", b"z" * 1024, a)
    vs.get_object("b", "src", b)
    moved_before = dict(vs.transfers.bytes_moved)
    assert moved_before.get((a, b)) == 1024
    rep = vs.meta.head_object("b", "src").latest.replicas[b]
    rep.ttl, rep.last_access = 1.0, 0.0
    clk.t = 3600.0
    vs.dispatch(CopyRequest("b", "src", "dst", b))
    assert vs.transfers.bytes_moved == moved_before
    assert vs.get_object("b", "dst", b) == b"z" * 1024
    assert vs.replica_regions("b", "dst") == [b]


def test_copy_read_repair_and_remote_transfer(store):
    cat, be, vs, _clk = store
    a, b, c = cat.region_names()
    vs.put_object("b", "src", b"y" * 256, a)
    vs.get_object("b", "src", b)
    be[b].delete("b", "src@v1")                  # bytes vanish at b
    vs.dispatch(CopyRequest("b", "src", "dst", b))
    assert vs.get_object("b", "dst", b) == b"y" * 256
    vs.dispatch(CopyRequest("b", "src", "dst2", c))     # pulled into c
    assert sum(n for (_s, d), n in vs.transfers.bytes_moved.items()
               if d == c) == 256


def test_delete_bucket_reclaims_multipart_spill(store):
    cat, be, vs, _clk = store
    a = cat.region_names()[0]
    vs.create_bucket("tmp")
    uid = vs.dispatch(CreateMultipartRequest("tmp", "k", a)).upload_id
    vs.dispatch(UploadPartRequest(uid, 1, b"x" * 32))
    assert len(list(be[a].list("tmp", MPU_PREFIX))) == 1
    vs.delete_bucket("tmp")
    assert list(be[a].list("tmp", MPU_PREFIX)) == [] and uid not in vs._mpu


def test_multipart_completion_streams_in_bounded_chunks(store):
    cat, be, vs, _clk = store
    a = cat.region_names()[0]
    vs.mpu_chunk_size = 1024
    chunks = []
    orig = be[a].put_stream

    def watched(bucket, key, it):
        return orig(bucket, key, (chunks.append(len(c)) or c for c in it))

    be[a].put_stream = watched
    payload = [bytes([65 + i]) * (3 * 1024 + (7 if i == 2 else 0))
               for i in range(3)]
    uid = vs.dispatch(CreateMultipartRequest("b", "huge", a)).upload_id
    etags = [vs.dispatch(UploadPartRequest(uid, i + 1, p)).etag
             for i, p in enumerate(payload)]
    r = vs.dispatch(CompleteMultipartRequest(
        "b", "huge", a, uid, parts=list(zip(range(1, 4), etags))))
    want = b"".join(payload)
    assert r.size == len(want) and vs.get_object("b", "huge", a) == want
    assert len(chunks) >= 9 and 0 < max(chunks) <= 1024


def test_multipart_streaming_policy_mode_replicates_cross_region(tmp_path):
    cat = pick_regions(3)
    a, b, _c = cat.region_names()
    be = make_backends(list(cat.region_names()), "fs", root=str(tmp_path))
    meta = MetadataServer(cat, mode="FB", versioning=False, device="cpu")
    vs = VirtualStore(cat, be, meta, mode="FB",
                      policy=make_policy("always_store", cat, device="cpu"),
                      device="cpu")
    vs.mpu_chunk_size = 512
    vs.create_bucket("b")
    vs.dispatch(PutRequest("b", "9", a, body=b"seed", at=0.0))
    uid = vs.dispatch(CreateMultipartRequest("b", "9", b, at=1.0)).upload_id
    part = bytes(range(256)) * 8
    vs.dispatch(UploadPartRequest(uid, 1, part))
    vs.dispatch(CompleteMultipartRequest("b", "9", b, uid, at=2.0))
    assert vs.get_object("b", "9", a) == part == vs.get_object("b", "9", b)
    om = meta.objects[("b", "9")]
    assert om.base_region == a and om.latest.replicas[a].pinned
    assert om.latest.replicas[b].status == COMMITTED


def test_virtualstore_and_simulator_implement_the_protocol():
    cat = pick_regions(3)
    vs = VirtualStore(cat, make_backends(list(cat.region_names()), "memory"),
                      device="cpu")
    sim = Simulator(cat, make_policy("always_store", cat, device="cpu"),
                    mode="FB")
    assert isinstance(vs, ObjectStoreAPI) and isinstance(sim, ObjectStoreAPI)


def test_live_and_simulated_hit_sequences_agree():
    cat = pick_regions(3)
    a, b, _ = cat.region_names()
    reqs = [PutRequest("bkt", "1", a, body=b"x" * 64, size=64, at=0.0),
            GetRequest("bkt", "1", b, at=10.0),
            GetRequest("bkt", "1", b, at=20.0),
            GetRequest("bkt", "1", a, at=30.0)]
    vs = VirtualStore(cat, make_backends(list(cat.region_names()), "memory"),
                      mode="FB", clock=lambda: 0.0, device="cpu")
    vs.create_bucket("bkt")
    live_hits = []
    for r in reqs:
        resp = vs.dispatch(r)
        if isinstance(r, GetRequest):
            live_hits.append(resp.hit)
    sim = Simulator(cat, make_policy("always_store", cat, device="cpu"),
                    mode="FB")
    for r in reqs:
        sim.dispatch(r)
    assert live_hits == [False, True, True]
    assert sim.report.n_miss == 1 and sim.report.n_hit == 2


# ---------------------------------------------------------------------------
# tests/test_system.py, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_bytes_survive_a_region_outage():
    """The storage half of ``test_end_to_end_train_checkpoint_failover``
    (the trainer is not ported): a checkpoint written at one region,
    replicated into another by a read there, survives the loss of the
    first region's bytes and reads back unchanged."""
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "memory")
    vs = VirtualStore(cat, be, mode="FB", device="cpu")
    _base, west, euro = cat.region_names()
    vs.create_bucket("ckpt")
    rng = np.random.default_rng(0)
    shards = {f"step-6/shard-{i}": rng.bytes(4096) for i in range(4)}
    for k, data in shards.items():
        vs.put_object("ckpt", k, data, west)
    for k in shards:
        assert vs.get_object("ckpt", k, euro) == shards[k]   # replicate
    for k in list(be[west]._data):
        be[west].delete(*k)                                  # west is gone
    vs.region_down(west)
    for k, data in shards.items():
        assert vs.get_object("ckpt", k, euro) == data


def test_paper_policy_ranking_2region():
    """Fig. 5 / Table 3 shape, on the port's simulator: SkyStore beats the
    static baselines on average across the five trace profiles and stays
    within 2x of the clairvoyant optimum."""
    cat = paper_2region_catalog()
    ratios = {p: [] for p in ("always_evict", "always_store", "t_even",
                              "skystore")}
    for name in ("T15", "T29", "T65", "T78", "T79"):
        tr = assign_two_region(generate_trace(name, seed=1),
                               "aws:us-east-1", "aws:us-west-1")
        cgp = run_policy(tr, cat, "cgp", mode="FB", device="cpu").policy_cost
        for p in ratios:
            ratios[p].append(run_policy(tr, cat, p, mode="FB",
                                        device="cpu").policy_cost / cgp)
    avg = {p: float(np.mean(v)) for p, v in ratios.items()}
    assert avg["skystore"] < avg["always_evict"]
    assert avg["skystore"] < avg["always_store"]
    assert avg["skystore"] <= avg["t_even"] + 0.05
    assert avg["skystore"] < 2.0
