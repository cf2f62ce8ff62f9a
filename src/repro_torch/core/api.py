"""The unified typed operation layer (paper §4.1/§4.3).

The PyTorch port's copy of :mod:`repro.core.api`; nothing here touches a
tensor.

SkyStore's promise is a *single* virtual object API that "appears global to
the user" while hiding multi-cloud placement.  This module is that surface,
expressed once as typed request/response objects so every layer speaks the
same language:

  * :class:`~repro_torch.core.virtual_store.VirtualStore` implements the protocol
    for live serving (bytes actually move between physical backends);
  * :class:`~repro_torch.core.s3_proxy.S3Proxy` is a pure wire codec: it parses the
    S3 REST dialect into these request objects and renders the responses back
    to XML -- it contains no placement logic of its own;
  * :class:`~repro_torch.core.simulator.Simulator` replays traces as the *same*
    request objects, so the cost model exercises the identical semantic path
    as production serving and policy behaviour cannot silently drift.

The shared placement rules (§2.3 cheapest-source GET routing, §4.4
write-local/base-pinning) live here too, as pure functions consumed by both
the metadata server and the simulator.

Errors are structured: :class:`ApiError` carries an S3 error code and the
matching HTTP status.  Codes that correspond to Python lookup failures
(``NoSuchKey``, ``NoSuchBucket``, ``NoSuchUpload``) also subclass
:class:`KeyError` (and ``BucketNotEmpty`` subclasses :class:`ValueError`) so
pre-existing ``except KeyError`` call sites keep working unchanged.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import re
from typing import (
    Dict, List, Mapping, Optional, Protocol, Sequence, Tuple, Union,
    runtime_checkable,
)

# ---------------------------------------------------------------------------
# Structured errors
# ---------------------------------------------------------------------------

#: S3 error code -> HTTP status.
ERROR_STATUS: Dict[str, int] = {
    "NoSuchKey": 404,
    "NoSuchBucket": 404,
    "NoSuchUpload": 404,
    "NoSuchVersion": 404,
    "NotModified": 304,
    "PreconditionFailed": 412,
    "InvalidRange": 416,
    "InvalidPart": 400,
    "InvalidPartOrder": 400,
    "InvalidArgument": 400,
    "InvalidRequest": 400,
    "BucketNotEmpty": 409,
    "ServiceUnavailable": 503,
    "InternalError": 500,
}

#: Extra bases per code, for backwards compatibility with callers that catch
#: plain KeyError / ValueError.
_COMPAT_BASES: Dict[str, tuple] = {
    "NoSuchKey": (KeyError,),
    "NoSuchBucket": (KeyError,),
    "NoSuchUpload": (KeyError,),
    "NoSuchVersion": (KeyError,),
    "BucketNotEmpty": (ValueError,),
    "InvalidArgument": (ValueError,),
}


class ApiError(Exception):
    """An S3-style structured error: ``ApiError("NoSuchKey", "b/k not found")``.

    Instantiating the base class with a known code returns an instance of a
    dedicated subclass (also inheriting KeyError/ValueError where that matches
    historic behaviour), so both ``except ApiError`` and legacy
    ``except KeyError`` call sites work.
    """

    code: str = "InternalError"

    def __new__(cls, code: str = "InternalError", message: str = ""):
        if cls is ApiError:
            cls = _ERROR_TYPES.get(code, cls)
        return super().__new__(cls, code, message)

    def __init__(self, code: str = "InternalError", message: str = ""):
        super().__init__(code, message)
        self.code = code
        self.message = message

    @property
    def http_status(self) -> int:
        return ERROR_STATUS.get(self.code, 500)

    def __str__(self) -> str:
        return f"{self.code}: {self.message}" if self.message else self.code


_ERROR_TYPES: Dict[str, type] = {
    code: type(code, (ApiError,) + _COMPAT_BASES.get(code, ()), {})
    for code in ERROR_STATUS
}


# ---------------------------------------------------------------------------
# Request / response objects
# ---------------------------------------------------------------------------

#: An unresolved HTTP byte range: (first, last) where either end may be None
#: -- (a, None) means "from a to the end", (None, n) means "the last n bytes".
ByteRange = Tuple[Optional[int], Optional[int]]


@dataclasses.dataclass
class ObjectSummary:
    key: str
    size: int
    etag: str
    last_modified: float


@dataclasses.dataclass
class Ack:
    """Empty success response (create/delete bucket, abort, ...)."""

    ok: bool = True


# -- bucket ops --------------------------------------------------------------

@dataclasses.dataclass
class CreateBucketRequest:
    bucket: str
    at: Optional[float] = None      # event time; None = implementation clock


@dataclasses.dataclass
class DeleteBucketRequest:
    bucket: str
    at: Optional[float] = None


@dataclasses.dataclass
class ListBucketsRequest:
    at: Optional[float] = None


@dataclasses.dataclass
class ListBucketsResponse:
    buckets: List[str]


# -- object ops --------------------------------------------------------------

@dataclasses.dataclass
class PutRequest:
    bucket: str
    key: str
    region: str
    body: Optional[bytes] = None    # None in simulation: only `size` matters
    size: Optional[int] = None
    at: Optional[float] = None

    @property
    def nbytes(self) -> int:
        if self.body is not None:
            return len(self.body)
        return int(self.size or 0)


@dataclasses.dataclass
class PutResponse:
    version: int
    etag: str


@dataclasses.dataclass
class GetRequest:
    bucket: str
    key: str
    region: str
    version: Optional[int] = None
    range_: Optional[ByteRange] = None
    if_match: Optional[str] = None
    if_none_match: Optional[str] = None
    at: Optional[float] = None


@dataclasses.dataclass
class GetResponse:
    body: Optional[bytes]
    etag: str
    size: int                       # full object size, even for ranged reads
    last_modified: float
    version: int
    content_range: Optional[Tuple[int, int, int]] = None  # (start, end, total)
    source_region: Optional[str] = None
    hit: bool = True
    #: Post-GET placement choice taken by the serving store -- "store"/"skip"
    #: on a miss (replicate-on-read or not), "keep"/"evict" on a hit
    #: (TTL re-arm vs. evict-now).  Internal observability for the
    #: differential replay harness (covers clairvoyant CGP decisions);
    #: never serialized on the S3 wire.
    placement_action: Optional[str] = None


@dataclasses.dataclass
class HeadRequest:
    bucket: str
    key: str
    #: issuing region, for per-request op charges; None = charge not modeled
    region: Optional[str] = None
    if_match: Optional[str] = None
    if_none_match: Optional[str] = None
    at: Optional[float] = None


@dataclasses.dataclass
class HeadResponse:
    key: str
    size: int
    etag: str
    last_modified: float
    version: int


@dataclasses.dataclass
class ListRequest:
    bucket: str
    prefix: str = ""
    max_keys: int = 1000
    continuation_token: Optional[str] = None
    delimiter: Optional[str] = None
    #: issuing region, for per-request op charges; None = charge not modeled
    region: Optional[str] = None
    at: Optional[float] = None


@dataclasses.dataclass
class ListResponse:
    contents: List[ObjectSummary]
    common_prefixes: List[str]
    is_truncated: bool
    next_continuation_token: Optional[str]

    @property
    def key_count(self) -> int:
        return len(self.contents) + len(self.common_prefixes)


@dataclasses.dataclass
class DeleteObjectRequest:
    bucket: str
    key: str
    region: Optional[str] = None
    at: Optional[float] = None


@dataclasses.dataclass
class DeleteObjectsRequest:
    """Batch delete (``POST /bucket?delete``)."""

    bucket: str
    keys: Sequence[str]
    region: Optional[str] = None
    at: Optional[float] = None


@dataclasses.dataclass
class DeleteObjectsResponse:
    deleted: List[str]
    errors: List[Tuple[str, str]]   # (key, error code)


@dataclasses.dataclass
class CopyRequest:
    bucket: str
    src_key: str
    dst_key: str
    region: str
    at: Optional[float] = None


@dataclasses.dataclass
class CopyResponse:
    version: int
    etag: str


# -- multipart upload --------------------------------------------------------

@dataclasses.dataclass
class CreateMultipartRequest:
    bucket: str
    key: str
    region: str
    at: Optional[float] = None


@dataclasses.dataclass
class CreateMultipartResponse:
    upload_id: str


@dataclasses.dataclass
class UploadPartRequest:
    upload_id: str
    part_number: int
    body: bytes
    at: Optional[float] = None


@dataclasses.dataclass
class UploadPartResponse:
    etag: str


@dataclasses.dataclass
class CompleteMultipartRequest:
    bucket: str
    key: str
    region: str
    upload_id: str
    #: The client-supplied part list [(part_number, etag), ...]; None means
    #: "whatever was uploaded" (legacy clients that send no manifest).
    parts: Optional[Sequence[Tuple[int, str]]] = None
    at: Optional[float] = None


@dataclasses.dataclass
class CompleteMultipartResponse:
    version: int
    etag: str
    size: int


@dataclasses.dataclass
class AbortMultipartRequest:
    upload_id: str
    at: Optional[float] = None


#: Every request type of the op surface (useful for codecs and dispatch maps).
Request = Union[
    CreateBucketRequest, DeleteBucketRequest, ListBucketsRequest,
    PutRequest, GetRequest, HeadRequest, ListRequest,
    DeleteObjectRequest, DeleteObjectsRequest, CopyRequest,
    CreateMultipartRequest, UploadPartRequest, CompleteMultipartRequest,
    AbortMultipartRequest,
]


@runtime_checkable
class ObjectStoreAPI(Protocol):
    """The single entry point every layer implements: one typed op in, one
    typed response out, :class:`ApiError` on failure."""

    def dispatch(self, op: Request):
        ...


# ---------------------------------------------------------------------------
# Shared placement semantics (§2.3 / §4.4) -- one rule set for the live
# store and the cost simulator.
# ---------------------------------------------------------------------------

#: The immutable "everything is up" default for availability-aware helpers.
NO_OUTAGE: frozenset = frozenset()


def choose_get_source(
    committed: Mapping[str, float], region: str, now: float, cost,
    unavailable: frozenset = NO_OUTAGE,
    size: float = 0.0, latency_weight: float = 0.0,
) -> Tuple[str, bool]:
    """Route a GET issued from ``region``: local hit if the region holds a
    live committed replica, else the cheapest committed source (§2.3).

    ``committed`` maps region -> expiry time (``inf`` for pinned replicas).
    Expired-but-not-yet-evicted replicas are used as a last resort, matching
    the lazy eviction scan of §4.2.

    ``unavailable`` is the §6.4 failure plane: replicas in downed regions
    cannot serve, so the GET fails over to the cheapest *reachable* source
    (the base-region fallback falls out: the pinned base is a holder), and
    raises ``ServiceUnavailable`` (HTTP 503) only when every holding region
    is down.

    ``latency_weight`` is the §6.3 latency-vs-egress knob: with a non-zero
    weight remote holders are scored ``egress_price + latency_weight *
    get_latency_ms(src, region, size)`` instead of price alone (ties still
    resolve by sorted region name).  The default 0.0 takes the price-only
    path verbatim, so existing decision streams are bit-identical.  This
    scalar routine is the reference oracle the vectorized
    :class:`repro_torch.core.routing.RoutingMatrix` must stay decision-identical
    to at every weight.
    """
    if not committed:
        raise ApiError("NoSuchKey", "no committed replica")
    reachable = {r: e for r, e in committed.items() if r not in unavailable}
    if not reachable:
        raise ApiError(
            "ServiceUnavailable",
            f"every replica-holding region is down ({sorted(committed)})")
    alive = {r: e for r, e in reachable.items() if e > now} or reachable
    hit = region in alive
    if hit:
        return region, True
    return cost.cheapest_source(alive, region, size, latency_weight), False


def resolve_put_region(
    region: str, base_region: Optional[str], unavailable: frozenset, cost,
) -> str:
    """Effective landing region for a write-local PUT (§2.3 + §6.4): the
    issuing region unless it is down, then the live base (the data has to
    end up there anyway), then the cheapest live region from the issuer's
    perspective.  Raises ``ServiceUnavailable`` on a full blackout."""
    if region not in unavailable:
        return region
    if base_region is not None and base_region not in unavailable:
        return base_region
    live = [r for r in cost.region_names() if r not in unavailable]
    if not live:
        raise ApiError("ServiceUnavailable", "every region is down")
    return cost.cheapest_source(live, region)


@dataclasses.dataclass(frozen=True)
class PutPlacement:
    base_region: str      # the FB base after this PUT (first writer wins)
    pinned: bool          # is the write-local replica the pinned base copy?
    sync_to_base: bool    # cross-region overwrite refreshes the base (§4.4)
    #: §6.4: the base is down right now, so the §4.4 sync is *deferred* --
    #: queued by the caller and replayed when the base region recovers.
    sync_deferred: bool = False


def resolve_put_placement(
    mode: str, base_region: Optional[str], region: str,
    unavailable: frozenset = NO_OUTAGE,
) -> PutPlacement:
    """Write-local placement (§2.3): the first PUT fixes the FB base region;
    later cross-region PUTs are synchronously replicated to it (§4.4 LWW).
    In FP mode nothing is pinned and no base sync happens.  ``region`` is
    the *effective* landing region (see :func:`resolve_put_region`); when
    the base itself is in ``unavailable`` the sync is deferred, not
    skipped."""
    base = base_region if base_region is not None else region
    if mode != "FB":
        return PutPlacement(base, False, False)
    if region == base:
        return PutPlacement(base, True, False)
    if base in unavailable:
        return PutPlacement(base, False, False, sync_deferred=True)
    return PutPlacement(base, False, True)


# ---------------------------------------------------------------------------
# Wire-level helpers (HTTP Range, conditional headers, continuation tokens)
# ---------------------------------------------------------------------------

_RANGE_RE = re.compile(r"^bytes=(\d*)-(\d*)$")


def parse_range_header(header: str) -> ByteRange:
    """``bytes=a-b`` / ``bytes=a-`` / ``bytes=-n`` -> an unresolved ByteRange.
    Multi-range requests are not supported."""
    m = _RANGE_RE.match(header.strip())
    if not m or (not m.group(1) and not m.group(2)):
        raise ApiError("InvalidRange", f"unparseable Range {header!r}")
    first = int(m.group(1)) if m.group(1) else None
    last = int(m.group(2)) if m.group(2) else None
    if first is not None and last is not None and last < first:
        raise ApiError("InvalidRange", f"inverted Range {header!r}")
    return first, last


def resolve_range(
    rng: Optional[ByteRange], size: int,
) -> Optional[Tuple[int, int]]:
    """Resolve an unresolved range against the object size into inclusive
    ``(start, end)``; raises ``InvalidRange`` (HTTP 416) if unsatisfiable."""
    if rng is None:
        return None
    first, last = rng
    if first is None:                      # suffix: last `last` bytes
        if not last or size == 0:
            raise ApiError("InvalidRange", f"unsatisfiable suffix range on size {size}")
        return max(0, size - last), size - 1
    if first >= size:
        raise ApiError("InvalidRange", f"start {first} beyond size {size}")
    end = size - 1 if last is None else min(last, size - 1)
    return first, end


def etag_matches(etag: str, header: str) -> bool:
    """RFC 7232 If-(None-)Match comparison (weak validators compared
    byte-equal after stripping the ``W/`` prefix and quotes)."""
    if header.strip() == "*":
        return True
    candidates = [c.strip() for c in header.split(",")]
    norm = etag.strip('"')
    for c in candidates:
        if c.startswith("W/"):
            c = c[2:]
        if c.strip('"') == norm:
            return True
    return False


def check_preconditions(
    etag: str, if_match: Optional[str], if_none_match: Optional[str],
) -> None:
    """Evaluate conditional-request headers against the selected version's
    ETag: failed ``If-Match`` -> 412, matched ``If-None-Match`` -> 304."""
    if if_match is not None and not etag_matches(etag, if_match):
        raise ApiError("PreconditionFailed", f'ETag "{etag}" does not match If-Match')
    if if_none_match is not None and etag_matches(etag, if_none_match):
        err = ApiError("NotModified", f'ETag "{etag}" matches If-None-Match')
        err.etag = etag          # a 304 must carry the validator (RFC 7232)
        raise err


def encode_continuation_token(last_item: str) -> str:
    return base64.urlsafe_b64encode(last_item.encode()).decode()


def decode_continuation_token(token: str) -> str:
    try:
        return base64.urlsafe_b64decode(token.encode()).decode()
    except (binascii.Error, UnicodeDecodeError) as e:
        raise ApiError("InvalidArgument", f"bad continuation token: {e}") from None
