"""S3 wire-protocol codec + HTTP endpoint (paper §4.3).

The PyTorch port's copy of :mod:`repro.core.s3_proxy`.  It holds no device
state: the store it fronts (a port :class:`~repro_torch.core.virtual_store.
VirtualStore`) is where the policy's TTL kernel runs.

The paper's data plane is an S3-compatible proxy "allowing users to
seamlessly port applications using the S3 interface".  This is that server --
but it is *only* a codec: each HTTP request is parsed into a typed
:mod:`repro_torch.core.api` request object, handed to the store's single
``dispatch(op)`` entry point, and the typed response is rendered back to S3
XML.  All placement semantics live behind the
:class:`~repro_torch.core.api.ObjectStoreAPI` protocol, so the proxy cannot drift
from the simulator or the virtual store.  One proxy runs per client region;
the proxy itself is stateless (§4.3) -- kill it and start another.

Operations (the full §4.3 surface):
  PUT    /bucket                        -> create bucket
  DELETE /bucket                        -> delete bucket
  GET    /                              -> list buckets
  GET    /bucket?list-type=2            -> list objects, paginated
         (&prefix, &max-keys, &continuation-token, &delimiter)
  PUT    /bucket/key                    -> put object (write-local)
  PUT    /bucket/key + x-amz-copy-source-> copy object
  GET    /bucket/key                    -> get object (replicate-on-read);
         Range / If-Match / If-None-Match honored (206 / 412 / 304)
  HEAD   /bucket/key                    -> head object (conditional too)
  DELETE /bucket/key                    -> delete object (404 if absent)
  POST   /bucket?delete                 -> batch delete (DeleteObjects)
  POST   /bucket/key?uploads            -> create multipart upload
  PUT    /bucket/key?uploadId&partNumber-> upload part
  POST   /bucket/key?uploadId           -> complete multipart upload
                                           (part manifest validated)
  DELETE /bucket/key?uploadId           -> abort multipart upload
"""

from __future__ import annotations

import threading
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse
from xml.sax.saxutils import escape

from .api import (
    AbortMultipartRequest,
    ApiError,
    CompleteMultipartRequest,
    CopyRequest,
    CreateBucketRequest,
    CreateMultipartRequest,
    DeleteBucketRequest,
    DeleteObjectRequest,
    DeleteObjectsRequest,
    GetRequest,
    GetResponse,
    HeadRequest,
    ListBucketsRequest,
    ListRequest,
    ListResponse,
    ObjectStoreAPI,
    PutRequest,
    UploadPartRequest,
    parse_range_header,
)

# ---------------------------------------------------------------------------
# XML codec helpers (pure functions: body bytes <-> request/response objects)
# ---------------------------------------------------------------------------


def _xml(body: str) -> bytes:
    return ('<?xml version="1.0" encoding="UTF-8"?>' + body).encode()


def _localname(tag: str) -> str:
    """Strip any XML namespace: ``{http://...}Key`` -> ``Key``.  Real S3 SDKs
    namespace their manifests; hand-rolled clients usually don't."""
    return tag.rsplit("}", 1)[-1]


def _iter_local(root: ET.Element, name: str):
    return (el for el in root.iter() if _localname(el.tag) == name)


def _findtext_local(el: ET.Element, name: str) -> Optional[str]:
    for child in el:
        if _localname(child.tag) == name:
            return child.text
    return None


def parse_delete_manifest(body: bytes) -> List[str]:
    """``<Delete><Object><Key>k</Key></Object>...</Delete>`` -> keys
    (namespace-agnostic, so boto3-style manifests parse too)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise ApiError("InvalidRequest", f"malformed Delete XML: {e}") from None
    keys = [el.text or "" for el in _iter_local(root, "Key")]
    if not keys:
        raise ApiError("InvalidRequest", "empty Delete manifest")
    return keys


def parse_parts_manifest(body: bytes) -> Optional[List[Tuple[int, str]]]:
    """``<CompleteMultipartUpload><Part><PartNumber>n</PartNumber>
    <ETag>e</ETag></Part>...`` -> [(n, etag), ...]; None for an empty body
    (legacy clients that send no manifest).  Namespace-agnostic; a
    well-formed manifest with zero parts is an error, not the legacy path."""
    if not body.strip():
        return None
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise ApiError("InvalidRequest", f"malformed part manifest: {e}") from None
    parts: List[Tuple[int, str]] = []
    for el in _iter_local(root, "Part"):
        num = _findtext_local(el, "PartNumber")
        if num is None:
            raise ApiError("InvalidPart", "Part without PartNumber")
        parts.append((int(num), (_findtext_local(el, "ETag") or "").strip()))
    if not parts:
        raise ApiError("InvalidRequest", "part manifest lists no parts")
    return parts


def render_list_buckets(buckets) -> bytes:
    items = "".join(f"<Bucket><Name>{escape(b)}</Name></Bucket>" for b in buckets)
    return _xml(f"<ListAllMyBucketsResult><Buckets>{items}</Buckets>"
                "</ListAllMyBucketsResult>")


def render_list_objects(bucket: str, req: ListRequest, resp: ListResponse) -> bytes:
    parts = [
        f"<ListBucketResult><Name>{escape(bucket)}</Name>",
        f"<Prefix>{escape(req.prefix)}</Prefix>",
        f"<KeyCount>{resp.key_count}</KeyCount>",
        f"<MaxKeys>{req.max_keys}</MaxKeys>",
        f"<IsTruncated>{'true' if resp.is_truncated else 'false'}</IsTruncated>",
    ]
    if resp.next_continuation_token:
        parts.append(f"<NextContinuationToken>{resp.next_continuation_token}"
                     "</NextContinuationToken>")
    for s in resp.contents:
        parts.append(f"<Contents><Key>{escape(s.key)}</Key>"
                     f"<Size>{s.size}</Size>"
                     f"<ETag>&quot;{s.etag}&quot;</ETag></Contents>")
    for p in resp.common_prefixes:
        parts.append(f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
                     "</CommonPrefixes>")
    parts.append("</ListBucketResult>")
    return _xml("".join(parts))


def render_delete_result(deleted, errors) -> bytes:
    items = [f"<Deleted><Key>{escape(k)}</Key></Deleted>" for k in deleted]
    items += [f"<Error><Key>{escape(k)}</Key><Code>{code}</Code></Error>"
              for k, code in errors]
    return _xml(f"<DeleteResult>{''.join(items)}</DeleteResult>")


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    store: ObjectStoreAPI = None    # injected by S3Proxy
    region: str = None

    # -- plumbing -----------------------------------------------------------
    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _split(self) -> Tuple[Optional[str], Optional[str], dict]:
        u = urlparse(self.path)
        parts = u.path.lstrip("/").split("/", 1)
        bucket = unquote(parts[0]) if parts[0] else None
        key = unquote(parts[1]) if len(parts) > 1 and parts[1] else None
        return bucket, key, parse_qs(u.query, keep_blank_values=True)

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/xml", headers: dict = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _error(self, code: int, s3code: str, msg: str,
               headers: Optional[dict] = None):
        body = b"" if self.command == "HEAD" else _xml(
            f"<Error><Code>{s3code}</Code><Message>{escape(msg)}</Message></Error>")
        self._reply(code, body, headers=headers)

    def _api_error(self, e: ApiError):
        if e.code == "NotModified":          # 304: no body, but RFC 7232
            etag = getattr(e, "etag", None)  # requires the validator ETag
            self._reply(304, headers={"ETag": f'"{etag}"'} if etag else None)
        elif e.code == "ServiceUnavailable":
            # §6.4: every replica-holding region is inside an outage window.
            # S3 outage/throttle semantics: 503 + Retry-After so SDK retry
            # loops back off instead of hammering the proxy.
            self._error(503, e.code, e.message or e.code,
                        headers={"Retry-After": "1"})
        else:
            self._error(e.http_status, e.code, e.message or e.code)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def _q1(self, q: dict, name: str, default: Optional[str] = None) -> Optional[str]:
        return q[name][0] if name in q else default

    # -- verbs ---------------------------------------------------------------
    def do_GET(self):
        bucket, key, q = self._split()
        try:
            if bucket is None:                        # ListBuckets
                r = self.store.dispatch(ListBucketsRequest())
                self._reply(200, render_list_buckets(r.buckets))
            elif key is None:                         # ListObjectsV2
                req = ListRequest(
                    bucket,
                    prefix=self._q1(q, "prefix", ""),
                    max_keys=int(self._q1(q, "max-keys", "1000")),
                    continuation_token=self._q1(q, "continuation-token"),
                    delimiter=self._q1(q, "delimiter") or None,
                )
                self._reply(200, render_list_objects(bucket, req,
                                                     self.store.dispatch(req)))
            else:                                     # GetObject
                rng = (parse_range_header(self.headers["Range"])
                       if "Range" in self.headers else None)
                version = self._q1(q, "versionId")
                r: GetResponse = self.store.dispatch(GetRequest(
                    bucket, key, self.region,
                    version=int(version) if version else None,
                    range_=rng,
                    if_match=self.headers.get("If-Match"),
                    if_none_match=self.headers.get("If-None-Match"),
                ))
                headers = {"ETag": f'"{r.etag}"',
                           "Accept-Ranges": "bytes",
                           "x-amz-version-id": str(r.version)}
                status = 200
                if r.content_range is not None:
                    start, end, total = r.content_range
                    headers["Content-Range"] = f"bytes {start}-{end}/{total}"
                    status = 206
                self._reply(status, r.body, "application/octet-stream", headers)
        except ApiError as e:
            self._api_error(e)
        except KeyError as e:
            self._error(404, "NoSuchKey", str(e))
        except ValueError as e:
            self._error(400, "InvalidArgument", str(e))

    def do_HEAD(self):
        bucket, key, _q = self._split()
        try:
            r = self.store.dispatch(HeadRequest(
                bucket, key,
                if_match=self.headers.get("If-Match"),
                if_none_match=self.headers.get("If-None-Match"),
            ))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(r.size))
            self.send_header("ETag", f'"{r.etag}"')
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("x-amz-version-id", str(r.version))
            self.end_headers()
        except ApiError as e:
            self._api_error(e)
        except KeyError as e:
            self._error(404, "NoSuchKey", str(e))

    def do_PUT(self):
        bucket, key, q = self._split()
        try:
            if key is None:                           # CreateBucket
                self.store.dispatch(CreateBucketRequest(bucket))
                self._reply(200)
            elif "partNumber" in q and "uploadId" in q:   # UploadPart
                r = self.store.dispatch(UploadPartRequest(
                    q["uploadId"][0], int(q["partNumber"][0]), self._body()))
                self._reply(200, headers={"ETag": f'"{r.etag}"'})
            elif "x-amz-copy-source" in self.headers:     # CopyObject
                src = unquote(self.headers["x-amz-copy-source"]).lstrip("/")
                sb, sk = src.split("/", 1)
                if sb != bucket:
                    raise ApiError("InvalidRequest",
                                   "cross-bucket copy not supported")
                r = self.store.dispatch(CopyRequest(bucket, sk, key,
                                                    self.region))
                self._reply(200, _xml("<CopyObjectResult>"
                                      f"<ETag>&quot;{r.etag}&quot;</ETag>"
                                      "</CopyObjectResult>"))
            else:                                     # PutObject
                r = self.store.dispatch(PutRequest(bucket, key, self.region,
                                                   body=self._body()))
                self._reply(200, headers={
                    "ETag": f'"{r.etag}"',
                    "x-amz-version-id": str(r.version)})
        except ApiError as e:
            self._api_error(e)
        except KeyError as e:
            self._error(404, "NoSuchKey", str(e))
        except ValueError as e:
            self._error(400, "InvalidArgument", str(e))

    def do_POST(self):
        bucket, key, q = self._split()
        try:
            if key is None and "delete" in q:         # DeleteObjects (batch)
                keys = parse_delete_manifest(self._body())
                r = self.store.dispatch(DeleteObjectsRequest(
                    bucket, keys, region=self.region))
                self._reply(200, render_delete_result(r.deleted, r.errors))
            elif key is not None and "uploads" in q:  # CreateMultipartUpload
                r = self.store.dispatch(CreateMultipartRequest(
                    bucket, key, self.region))
                self._reply(200, _xml(
                    "<InitiateMultipartUploadResult>"
                    f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                    f"<UploadId>{r.upload_id}</UploadId>"
                    "</InitiateMultipartUploadResult>"))
            elif key is not None and "uploadId" in q:  # CompleteMultipartUpload
                parts = parse_parts_manifest(self._body())
                r = self.store.dispatch(CompleteMultipartRequest(
                    bucket, key, self.region, q["uploadId"][0], parts=parts))
                self._reply(200, _xml(
                    "<CompleteMultipartUploadResult>"
                    f"<Key>{escape(key)}</Key>"
                    f"<ETag>&quot;{r.etag}&quot;</ETag>"
                    "</CompleteMultipartUploadResult>"))
            else:
                raise ApiError("InvalidRequest", "unsupported POST")
        except ApiError as e:
            self._api_error(e)
        except KeyError as e:
            self._error(404, "NoSuchUpload", str(e))
        except ValueError as e:
            self._error(400, "InvalidArgument", str(e))

    def do_DELETE(self):
        bucket, key, q = self._split()
        try:
            if key is None:                           # DeleteBucket
                self.store.dispatch(DeleteBucketRequest(bucket))
            elif "uploadId" in q:                     # AbortMultipartUpload
                self.store.dispatch(AbortMultipartRequest(q["uploadId"][0]))
            else:                                     # DeleteObject
                self.store.dispatch(DeleteObjectRequest(bucket, key,
                                                        region=self.region))
            self._reply(204)
        except ApiError as e:
            self._api_error(e)
        except KeyError as e:
            self._error(404, "NoSuchKey", str(e))
        except ValueError as e:
            self._error(409, "Conflict", str(e))


class S3Proxy:
    """One region's stateless S3 endpoint over any :class:`ObjectStoreAPI`."""

    def __init__(self, store: ObjectStoreAPI, region: str,
                 host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,),
                       {"store": store, "region": region})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.region = region
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "S3Proxy":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
