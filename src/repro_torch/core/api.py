"""The typed operation layer (paper §4.1/§4.3) -- the part the cost plane uses.

The PyTorch port's copy of what :class:`~repro_torch.core.simulator.Simulator`
and :mod:`repro_torch.core.traces` import from :mod:`repro_torch.core.api`: the
request objects a trace replays as, the structured :class:`ApiError`, and the
shared placement rules (§2.3 cheapest-source GET routing, §4.4
write-local/base-pinning).  The live store's responses, multipart and wire
helpers belong to the live plane and are not ported yet.

Errors are structured: :class:`ApiError` carries an S3 error code and the
matching HTTP status.  Codes that correspond to Python lookup failures
(``NoSuchKey``, ``NoSuchBucket``, ``NoSuchUpload``) also subclass
:class:`KeyError` (and ``BucketNotEmpty`` subclasses :class:`ValueError`) so
``except KeyError`` call sites keep working.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

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


#: An unresolved HTTP byte range: (first, last) where either end may be None
#: -- (a, None) means "from a to the end", (None, n) means "the last n bytes".
ByteRange = Tuple[Optional[int], Optional[int]]


# ---------------------------------------------------------------------------
# Request objects
# ---------------------------------------------------------------------------

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
class HeadRequest:
    bucket: str
    key: str
    #: issuing region, for per-request op charges; None = charge not modeled
    region: Optional[str] = None
    if_match: Optional[str] = None
    if_none_match: Optional[str] = None
    at: Optional[float] = None


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
class DeleteObjectRequest:
    bucket: str
    key: str
    region: Optional[str] = None
    at: Optional[float] = None


#: Every request type a trace replays as.
Request = Union[PutRequest, GetRequest, HeadRequest, ListRequest,
                DeleteObjectRequest]


# ---------------------------------------------------------------------------
# Shared placement semantics (§2.3 / §4.4)
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

