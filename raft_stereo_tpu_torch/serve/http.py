"""graftwire: hardened stdlib HTTP/1.1 ingress over ``StereoService``.

The port's copy of the JAX package's ``serve/http.py``, every defense
kept. ``X-Raft-Session`` makes consecutive POSTs one video stream (each
frame warm-starts from the previous one, ``serve/stream.py``) and
``X-Raft-Converge-Tol`` sets a frame's convergence tolerance.

The wire protocol, with the same discipline as the rest of
the serving stack — stdlib only (``http.server`` + ``threading``), no new
dependencies, and every hostile-client defense proven by the wire chaos
battery rather than claimed:

- **hard content-length cap before any buffering** (``RAFT_HTTP_BODY_MAX``):
  an oversize declaration is 413 without reading a single body byte, and
  a missing/chunked length is 411 — the ingress never reads an unbounded
  body;
- **bounded, deadline-guarded streaming body read**: the connection
  carries a per-read socket timeout (``RAFT_HTTP_READ_TIMEOUT_MS``; a
  stalled client costs one timeout, not a pinned acceptor thread) AND
  the whole body must land within ``BODY_DEADLINE_FACTOR`` read-timeouts
  — a slow-loris trickling one byte per timeout is evicted at the
  deadline, not at heat death;
- **decode offload**: JPEG/PNG decode — tens of ms a frame at serving
  shapes, the host path's cap — runs in a small bounded worker pool
  (the serving twin of the scheduler's ``_Uploader``: overlap host work with
  device work, keep the acceptor thread on socket duty), behind the
  decompression-bomb guard (header-declared pixels vs
  ``RAFT_DECODE_MAX_PIXELS``, rejected before the decoder allocates);
- **per-tenant admission quotas**: a token bucket per ``X-Raft-Tenant``
  (``RAFT_TENANT_RATE`` = ``rate[:burst]`` requests/s), checked on the
  headers BEFORE the body is read — a quota-blown tenant costs the
  server a header parse, not an upload; the tenant map is LRU-bounded so
  hostile tenant-name churn cannot grow memory;
- **honest status mapping** (serve/wire.py): queue_full /
  service_draining are 503 + Retry-After, quota is 429, admission
  rejects are 400 with the existing stable codes, expired deadlines are
  504 — the structured response serializes to the wire unchanged;
- **every response is structured JSON**, including the parse-failure
  paths inside ``http.server`` itself (``send_error`` is overridden):
  a header flood is a JSON 431, not an HTML apology;
- **SIGTERM rides the service's drain** (``python -m
  raft_stereo_tpu_torch.serve_stereo --http_port``):
  late requests get 503 ``service_draining``, admitted rows run to
  their segment-boundary exits, the listener then stops accepting and
  the process exits 0.

Observability: the frontend shares the service's ONE registry —
``raft_http_responses_total{status=,code=}`` (exactly one increment per
request that reached routing, ``client_disconnect`` included, which is
what lets the chaos storm reconcile counters with wire outcomes),
per-tenant admission counters, body-byte and decode-time instruments —
and every request's trace opens at the wire (``ingress_read`` /
``decode`` spans precede the service's ``admission`` span on the same
timeline).

All four knobs are host-side serving behavior, resolved once at frontend
construction (explicit config > env > default, named-ValueError parsing),
and registered in ``analysis/knobs.py`` ``SERVE_ENV_KNOBS`` with the
stays-out-of-the-fingerprint rationale: none of them shapes a compiled
program.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from raft_stereo_tpu_torch.obs.deck import thread_stacks
from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
# ONE sanitizer (obs/usage.py) shared by quota keys, usage accounting
# and metric labels — re-exported here under its historical name.
from raft_stereo_tpu_torch.obs.usage import sanitize_tenant  # noqa: F401
from raft_stereo_tpu_torch.serve import wire
from raft_stereo_tpu_torch.serve.supervise import _parse_number

logger = logging.getLogger(__name__)

DEFAULT_HTTP_PORT = 8080
DEFAULT_BODY_MAX = 64 << 20          # 64 MiB: two full-res PNGs + slack
DEFAULT_READ_TIMEOUT_MS = 5_000.0

#: The whole body must arrive within this many read-timeouts: the
#: per-read socket timeout alone only catches a FULLY stalled client — a
#: slow-loris sending one byte per (timeout - epsilon) would hold the
#: acceptor for body_len timeouts without it.
BODY_DEADLINE_FACTOR = 8

#: Streaming body read chunk; bounds the per-read allocation.
READ_CHUNK = 64 << 10

#: Bound on read-and-discard of a rejected request's unread body (the
#: Go stdlib's maxPostHandlerReadBytes idea): closing a socket with
#: unread receive-buffer data emits TCP RST, which can destroy the
#: structured rejection in flight — so rejects drain up to this much
#: declared body first. Bodies larger than this still risk the RST
#: (draining them fully would hand rejected clients unbounded upload
#: bandwidth, the opposite of what the caps are for).
REJECT_DRAIN_MAX = 256 << 10

#: Upper bound on one request's wait for its service response. The
#: service contractually resolves every Future (supervision), so
#: this is a last-ditch acceptor-thread guard, not a policy knob.
RESPONSE_WAIT_S = 600.0

#: Wait for a decode-pool slot + decode itself. Decode of an admitted
#: (cap-checked) image is bounded work; this bounds pool-backlog waits.
DECODE_WAIT_S = 60.0

#: JSON codes for responses generated inside http.server's own parsing
#: (our send_error override maps the numeric status to a stable code).
_HTTP_ERROR_CODES = {
    400: "bad_request",
    408: "read_timeout",
    411: "length_required",
    414: "uri_too_long",
    431: "too_many_headers",
    501: "unsupported_method",
    505: "bad_http_version",
}


def resolve_http_port(value: Optional[int] = None) -> int:
    """Effective listen port: explicit config wins (0 = ephemeral, the
    test/bench path), else ``RAFT_HTTP_PORT``, else 8080."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_HTTP_PORT", "").strip()
    if not raw:
        return DEFAULT_HTTP_PORT
    return _parse_number("RAFT_HTTP_PORT", raw, int)


def resolve_body_max(value: Optional[int] = None) -> int:
    """Effective content-length cap in bytes: explicit config wins, else
    ``RAFT_HTTP_BODY_MAX``, else 64 MiB."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_HTTP_BODY_MAX", "").strip()
    if not raw:
        return DEFAULT_BODY_MAX
    return _parse_number("RAFT_HTTP_BODY_MAX", raw, int)


def resolve_read_timeout_ms(value: Optional[float] = None) -> float:
    """Effective per-read socket timeout in ms: explicit config wins,
    else ``RAFT_HTTP_READ_TIMEOUT_MS``, else 5 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_HTTP_READ_TIMEOUT_MS", "").strip()
    if not raw:
        return DEFAULT_READ_TIMEOUT_MS
    return _parse_number("RAFT_HTTP_READ_TIMEOUT_MS", raw, float)


def resolve_tenant_rate(value: Optional[str] = None
                        ) -> Optional[Tuple[float, float]]:
    """Effective per-tenant quota as ``(rate_per_s, burst)``: explicit
    config wins, else ``RAFT_TENANT_RATE``, else None (unlimited — the
    single-operator default; a fleet sets it).  Format ``rate[:burst]``,
    e.g. ``"10"`` or ``"10:20"``; burst defaults to ``max(1, rate)``.
    Malformed values raise a ValueError naming the variable."""
    raw = value if value is not None else \
        os.environ.get("RAFT_TENANT_RATE", "").strip()
    if not raw:
        return None
    rate_s, _, burst_s = str(raw).partition(":")
    rate = _parse_number("RAFT_TENANT_RATE", rate_s.strip(), float)
    if rate <= 0:
        raise ValueError(
            f"RAFT_TENANT_RATE rate must be positive, got {raw!r}")
    burst = (_parse_number("RAFT_TENANT_RATE", burst_s.strip(), float)
             if burst_s.strip() else max(1.0, rate))
    if burst < 1:
        raise ValueError(
            f"RAFT_TENANT_RATE burst must be >= 1, got {raw!r}")
    return rate, burst


@dataclasses.dataclass(frozen=True)
class HttpConfig:
    """Ingress knobs. Every ``None`` resolves env > default at
    construction; all of it is host-side serving behavior — no compiled
    program's bytes depend on any field (the SERVE_ENV_KNOBS rationale).
    """

    host: str = "127.0.0.1"           # bind address; CLI widens to 0.0.0.0
    port: Optional[int] = None        # None -> RAFT_HTTP_PORT; 0 = ephemeral
    body_max: Optional[int] = None    # None -> RAFT_HTTP_BODY_MAX
    read_timeout_ms: Optional[float] = None  # None -> RAFT_HTTP_READ_TIMEOUT_MS
    tenant_rate: Optional[str] = None  # None -> RAFT_TENANT_RATE; "" = off
    decode_workers: int = 2           # decode offload pool width
    decode_max_pixels: Optional[int] = None  # None -> RAFT_DECODE_MAX_PIXELS
    max_tenants: int = 1024           # bound on quota buckets + labels
    max_connections: int = 128        # concurrent-connection cap (handler
    #                                   threads); excess connections get an
    #                                   immediate 503 ``overloaded``


class _TokenBucket:
    """Classic continuous-refill token bucket; caller holds the map lock
    (the bucket itself is plain state, not self-locking)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = now

    def refill(self, now: float) -> float:
        self.tokens = min(self.burst,
                          self.tokens + max(0.0, now - self.t_last)
                          * self.rate)
        self.t_last = now
        return self.tokens

    def consume(self, now: float) -> bool:
        if self.refill(now) >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class TenantQuotas:
    """Bounded per-tenant token buckets on the wall clock (quota is
    an operational rate, like drain deadlines — a FakeClock session must
    not freeze refill). ``limit=None`` admits everything.

    Two hostile-cardinality defenses, both capped at ``max_tenants``:

    - bucket map: when full, a NEW tenant claims a slot only by
      losslessly evicting a bucket that has refilled to full burst
      (re-creating such a bucket would start full anyway); if every
      tracked bucket still holds spent state, the newcomer shares one
      overflow bucket — so churning fresh tenant names can never reset a
      tracked tenant's spent tokens back to a full burst;
    - metric labels (:meth:`label`): the first ``max_tenants`` distinct
      names keep their own label, later names share ``__other__`` — the
      metrics registry keeps every (name, labels) instrument forever, so
      the label set must be bounded here, quota configured or not.
    """

    OVERFLOW_LABEL = "__other__"

    def __init__(self, limit: Optional[Tuple[float, float]],
                 max_tenants: int = 1024):
        self.limit = limit
        self.max_tenants = max_tenants
        self._buckets: "OrderedDict[str, _TokenBucket]" = OrderedDict()
        self._overflow: Optional[_TokenBucket] = None
        self._labels: set = set()
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        """Metric-safe tenant label: the name itself while the label set
        has room, the shared overflow label after."""
        with self._lock:
            if tenant in self._labels:
                return tenant
            if len(self._labels) < self.max_tenants:
                self._labels.add(tenant)
                return tenant
            return self.OVERFLOW_LABEL

    def _bucket_for(self, tenant: str, rate: float, burst: float,
                    now: float) -> _TokenBucket:
        # Caller holds self._lock.
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            self._buckets.move_to_end(tenant)
            return bucket
        if len(self._buckets) >= self.max_tenants:
            for name, b in self._buckets.items():  # LRU -> MRU order
                if b.refill(now) >= b.burst:
                    del self._buckets[name]
                    break
            else:
                if self._overflow is None:
                    self._overflow = _TokenBucket(rate, burst, now)
                return self._overflow
        bucket = self._buckets[tenant] = _TokenBucket(rate, burst, now)
        return bucket

    def admit(self, tenant: str) -> bool:
        if self.limit is None:
            return True
        rate, burst = self.limit
        now = time.monotonic()
        with self._lock:
            return self._bucket_for(tenant, rate, burst, now).consume(now)

    def would_admit(self, tenant: str) -> bool:
        """Non-consuming peek for the Expect: 100-continue gate: would
        ``admit`` succeed right now? The token is only spent by the real
        ``admit`` once the body arrives (a race between peek and spend
        just means the later real check rejects — never a double
        spend)."""
        if self.limit is None:
            return True
        rate, burst = self.limit
        now = time.monotonic()
        with self._lock:
            return self._bucket_for(tenant, rate, burst,
                                    now).refill(now) >= 1.0

    def status(self) -> Dict:
        with self._lock:
            n = len(self._buckets)
            overflow = self._overflow is not None
        return {"limit": (None if self.limit is None
                          else {"rate_per_s": self.limit[0],
                                "burst": self.limit[1]}),
                "tenants_tracked": n,
                "max_tenants": self.max_tenants,
                "overflow_bucket_active": overflow}


class _IngressHandler(BaseHTTPRequestHandler):
    """One connection's request loop. ``frontend`` and ``timeout`` are
    stamped on the per-frontend subclass (``HttpFrontend`` builds it), so
    the stdlib machinery applies the per-read socket timeout in
    ``setup()`` for free."""

    protocol_version = "HTTP/1.1"
    server_version = "raft-stereo-tpu"
    sys_version = ""
    frontend: "HttpFrontend" = None  # type: ignore[assignment]

    # -- plumbing ----------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("http %s %s", self.address_string(), fmt % args)

    def _count_response(self, status: int, code: str) -> None:
        self.frontend.registry.counter(
            "raft_http_responses_total",
            "HTTP responses by status and structured code",
            status=str(status), code=code).inc()

    def send_error(self, code, message=None, explain=None):
        """Structured-JSON replacement for the stdlib HTML error page —
        this is also the path http.server's OWN parser failures take
        (header floods -> 431, oversized request lines -> 414), so even
        a request that never reached routing gets a structured body."""
        stable = _HTTP_ERROR_CODES.get(code, f"http_{code}")
        self._send_json(code, {"status": "rejected", "code": stable,
                               "message": message or stable},
                        code_label=stable, close=True)

    def _send_json(self, status: int, doc, code_label: str,
                   close: bool = False,
                   headers: Optional[Dict[str, str]] = None,
                   content_type: str = "application/json",
                   head: bool = False) -> None:
        status = int(status)  # http.server hands HTTPStatus enums to
        #                       send_error; labels must be plain digits
        body = (doc if isinstance(doc, bytes)
                else json.dumps(doc, default=str).encode("utf-8"))
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            if not head:  # HEAD: the GET twin's headers, no body
                self.wfile.write(body)
        except (BrokenPipeError, ConnectionError, socket.timeout,
                TimeoutError, OSError):
            # The client vanished mid-response (the chaos storm's
            # disconnect fault): the request still gets exactly ONE
            # accounting entry, the thread survives, the connection dies.
            self.close_connection = True
            code_label = "client_disconnect"
        self._count_response(status, code_label)

    # -- routing -----------------------------------------------------------

    def _route(self):
        path = self.path.split("?", 1)[0]
        fe = self.frontend
        if self.command != "POST" and self._declares_body():
            # A bodyless-verb request smuggling a body would leave its
            # bytes unread and a keep-alive reuse would parse them as
            # the next request line — two accounting entries for one
            # request. Drain (bounded) and close after answering.
            self._drain_rejected_body()
            self.close_connection = True
        if self.command in ("GET", "HEAD"):
            # HEAD is the header-only GET twin (RFC 9110): LB and
            # uptime probes commonly use HEAD (`curl -I`), and a 405 on
            # /healthz would rotate a healthy instance out.
            head = self.command == "HEAD"
            if path == "/healthz":
                return self._send_json(
                    200, fe.status_doc(), code_label="healthz",
                    head=head)
            if path == "/metrics":
                return self._send_json(
                    200, fe.service.metrics_text().encode("utf-8"),
                    code_label="metrics",
                    content_type="text/plain; version=0.0.4", head=head)
            # Operator plane (graftdeck, DESIGN.md r15): read-only,
            # bounded debug endpoints — same dispatch boundary, same
            # connection caps, same counted accounting as every other
            # route (a debug endpoint is still a hostile-client surface).
            if path == "/debug/ticks":
                return self._send_json(
                    200, fe.debug_ticks_doc(self.path),
                    code_label="debug_ticks", head=head)
            if path == "/debug/usage":
                return self._send_json(
                    200, fe.service.session.usage.doc(),
                    code_label="debug_usage", head=head)
            if path == "/debug/stacks":
                return self._send_json(
                    200, thread_stacks(),
                    code_label="debug_stacks", head=head)
            if path == "/debug/config":
                return self._send_json(
                    200, fe.debug_config_doc(),
                    code_label="debug_config", head=head)
            if head:  # 405/404 bodies would desync strict HEAD framing
                label = ("method_not_allowed" if path == "/v1/stereo"
                         else "unknown_route")
                return self._send_json(
                    405 if path == "/v1/stereo" else 404, b"",
                    code_label=label, close=True, head=True)
            if path == "/v1/stereo":
                return self._reject(405, "method_not_allowed",
                                    "stereo requests are POST")
            return self._reject(404, "unknown_route",
                                f"no route {path!r}")
        if self.command == "POST":
            if path == "/v1/stereo":
                return self._do_stereo()
            if path in ("/healthz", "/metrics") or \
                    path.startswith("/debug/"):
                return self._reject(405, "method_not_allowed",
                                    f"{path} is GET")
            return self._reject(404, "unknown_route", f"no route {path!r}")
        return self._reject(405, "method_not_allowed",
                            f"method {self.command} is not supported")

    #: Body bytes consumed for the CURRENT request (class default covers
    #: paths that never read a body); _read_body advances it so the
    #: reject-path drain knows how much declared body is still unread.
    _body_consumed = 0

    def _dispatch(self):
        """Crash-proof boundary around routing: an unexpected exception
        becomes a 500 and a counted crash, never a dead acceptor thread
        (the wire chaos battery asserts the crash counter stays 0)."""
        self._body_consumed = 0  # keep-alive: reset per request
        try:
            self._route()
        except Exception as e:  # noqa: BLE001 — the acceptor boundary
            self.frontend.registry.counter(
                "raft_http_handler_crashes_total",
                "unexpected exceptions escaping request routing").inc()
            logger.exception("unhandled ingress error")
            self._send_json(500, {"status": "error", "code": "internal",
                                  "message": f"{type(e).__name__}: {e}"},
                            code_label="internal", close=True)

    # EVERY verb routes through _dispatch: the crash-to-structured-500
    # boundary and the per-request _body_consumed reset must cover all
    # of them (a keep-alive connection reuses this handler instance).
    do_GET = do_POST = do_HEAD = _dispatch
    do_PUT = do_DELETE = do_PATCH = _dispatch

    def handle_expect_100(self):
        """A client politely asking before uploading gets every
        header-stage verdict BEFORE a 100 invites a doomed body — the
        SAME gate set ``_do_stereo`` runs (one shared copy, peek mode:
        quota is checked non-consuming and rejects skip the drain, the
        client is still waiting to send)."""
        if (self.command == "POST"
                and self.path.split("?", 1)[0] == "/v1/stereo"
                and self._gate_stereo_headers(peek=True) is None):
            return False
        return super().handle_expect_100()

    def _drain_rejected_body(self) -> None:
        """Read-and-discard (bounded) what remains of a rejected
        request's declared body: closing with unread receive-buffer
        data emits TCP RST, which can destroy the structured response
        before the client reads it. Every read is under the socket
        timeout, so a client that declared a body and sent nothing
        costs at most one timeout."""
        req_headers = getattr(self, "headers", None)
        raw_len = req_headers.get("Content-Length") if req_headers else None
        try:
            declared = int(raw_len)
        except (TypeError, ValueError):
            return
        budget = min(declared - self._body_consumed, REJECT_DRAIN_MAX)
        deadline = time.monotonic() + self.frontend.body_deadline_s
        while budget > 0 and time.monotonic() < deadline:
            try:
                chunk = self.rfile.read1(min(budget, READ_CHUNK))
            except (OSError, ValueError):
                return
            if not chunk:
                return
            budget -= len(chunk)
            # Advance the consumed count: a second drain on the same
            # request (route-level then reject-level) must be a no-op,
            # not a blocking re-read of an empty socket.
            self._body_consumed += len(chunk)

    def _declares_body(self) -> bool:
        """Does the request declare body bytes on the wire? Truthiness
        of the raw header is not enough — ``Content-Length: 0`` is a
        benign bodyless declaration some clients send on every request,
        and treating it as a smuggled body would force a reconnect per
        keep-alive probe."""
        if self.headers.get("Transfer-Encoding"):
            return True
        raw = self.headers.get("Content-Length")
        if raw is None:
            return False
        try:
            return int(raw) > 0
        except ValueError:
            return True  # unparseable: assume bytes may follow

    def _reject(self, status: int, code: str, message: str,
                headers: Optional[Dict[str, str]] = None,
                drain: bool = True) -> None:
        # Wire-level rejections close the connection: the request body
        # (if any) was not necessarily fully consumed, and a keep-alive
        # reuse would parse leftover body bytes as the next request
        # line. The bounded drain first, so small-bodied clients get
        # the structured answer instead of a mid-upload RST.
        if drain:
            self._drain_rejected_body()
        self._send_json(status, {"status": "rejected", "code": code,
                                 "message": message},
                        code_label=code, close=True, headers=headers)

    # -- the stereo POST ---------------------------------------------------

    def _read_body(self, length: int) -> bytes:
        """Bounded, deadline-guarded streaming read. The per-read socket
        timeout (connection-level, from ``setup()``) catches a fully
        stalled client; the total deadline catches the slow-loris that
        stays just under it. Short reads (client closed early) are
        ``truncated_body``."""
        deadline = time.monotonic() + \
            self.frontend.body_deadline_s
        chunks = []
        remaining = length
        while remaining > 0:
            if time.monotonic() >= deadline:
                raise wire.WireRejected(
                    "read_timeout",
                    f"request body did not arrive within "
                    f"{self.frontend.body_deadline_s:.1f}s",
                    http_status=408)
            try:
                # read1, not read: a buffered read(n) loops raw recvs
                # until n bytes arrive, and a client trickling one byte
                # per (timeout - epsilon) would keep a single 64 KiB
                # read alive ~indefinitely without ever tripping the
                # socket timeout OR the deadline check above. read1 does
                # at most ONE raw recv, so the deadline is re-checked at
                # least once per per-read timeout no matter how slowly
                # bytes arrive.
                chunk = self.rfile.read1(min(remaining, READ_CHUNK))
            except (socket.timeout, TimeoutError):
                raise wire.WireRejected(
                    "read_timeout",
                    "socket read stalled past the per-read timeout",
                    http_status=408) from None
            if not chunk:
                raise wire.WireRejected(
                    "truncated_body",
                    f"client closed after {length - remaining} of "
                    f"{length} declared body bytes")
            chunks.append(chunk)
            remaining -= len(chunk)
            self._body_consumed = length - remaining
        return b"".join(chunks)

    def _gate_stereo_headers(self, peek: bool) -> Optional[int]:
        """The header-stage gates for POST /v1/stereo — quota first (a
        blown quota costs the server a header parse, never an upload),
        then chunked 411, Content-Length parse/negative/cap, and the
        media type (an unsupported one must not cost a body_max-sized
        read before its 415; the codec re-checks after the body lands,
        so it stays correct standalone).

        ONE copy shared by both callers so the gate sets cannot drift:
        ``_do_stereo`` (``peek=False``: quota consumes, rejects drain)
        and the ``Expect: 100-continue`` hook (``peek=True``: quota is
        a non-consuming peek — the token is spent by the real check
        once the body arrives — and no drain, the client is still
        waiting to send). Returns the validated Content-Length, or
        ``None`` when a rejection was sent."""
        fe = self.frontend
        drain = not peek
        tenant = sanitize_tenant(self.headers.get("X-Raft-Tenant"))
        ok = (fe.quotas.would_admit(tenant) if peek
              else fe.quotas.admit(tenant))
        if not ok:
            # Counted in the tenant series from BOTH callers: an
            # Expect-gated 429 is still a quota rejection served to
            # that tenant, and curl sends Expect by default for
            # multipart bodies.
            fe.registry.counter(
                "raft_http_tenant_requests_total",
                "stereo requests by tenant and admission outcome",
                tenant=fe.quotas.label(tenant),
                outcome="quota_exceeded").inc()
            self._reject(
                429, "quota_exceeded",
                f"tenant {tenant!r} is over its admission rate",
                headers={"Retry-After":
                         str(wire.RETRY_AFTER_S["quota_exceeded"])},
                drain=drain)
            return None
        if self.headers.get("Transfer-Encoding"):
            self._reject(
                411, "length_required",
                "chunked bodies are not accepted — send Content-Length",
                drain=drain)
            return None
        raw_len = self.headers.get("Content-Length")
        if raw_len is None:
            self._reject(411, "length_required",
                         "POST /v1/stereo requires Content-Length",
                         drain=drain)
            return None
        try:
            length = int(raw_len)
        except ValueError:
            self._reject(
                400, "bad_content_length",
                f"Content-Length must be an integer, got {raw_len!r}",
                drain=drain)
            return None
        if length < 0:
            self._reject(400, "bad_content_length",
                         f"negative Content-Length {length}", drain=drain)
            return None
        if length > fe.body_max:
            self._reject(
                413, "body_too_large",
                f"declared body of {length} bytes exceeds the cap of "
                f"{fe.body_max} (RAFT_HTTP_BODY_MAX)", drain=drain)
            return None
        media, _ = wire.parse_content_type(self.headers.get("Content-Type"))
        if media not in wire.SUPPORTED_MEDIA:
            self._reject(
                415, "unsupported_media_type",
                f"content-type {media or '(none)'!r} is not one of "
                f"{', '.join(wire.SUPPORTED_MEDIA)}", drain=drain)
            return None
        return length

    def _do_stereo(self) -> None:
        fe = self.frontend
        tenant = sanitize_tenant(self.headers.get("X-Raft-Tenant"))

        tenant_label = fe.quotas.label(tenant)

        def tenant_count(outcome: str) -> None:
            fe.registry.counter(
                "raft_http_tenant_requests_total",
                "stereo requests by tenant and admission outcome",
                tenant=tenant_label, outcome=outcome).inc()

        length = self._gate_stereo_headers(peek=False)
        if length is None:
            return

        # Ingress trace: opened at the wire so the read/decode phases
        # join the same timeline the service's admission span lands on.
        trace = fe.service.tracer.start_request(
            self.headers.get("X-Raft-Id"))
        try:
            body = self._read_body(length)
        except wire.WireRejected as e:
            trace.finish(status="rejected", code=e.code)
            # No drain on a read timeout: the client already proved it
            # stalls, a drain attempt would just burn a second timeout
            # before the eviction.
            return self._reject(e.http_status, e.code, str(e),
                                drain=(e.code != "read_timeout"))
        fe.registry.counter(
            "raft_http_body_bytes_total",
            "request body bytes read off the wire").inc(len(body))
        # Per-tenant wire accounting (obs/usage.py): request-body bytes
        # in; the response bytes land below once encoded.
        fe.service.session.usage.add_bytes(
            fe.service.session.usage.label(tenant), n_in=len(body))
        trace.mark("ingress_read", bytes=len(body), tenant=tenant)

        try:
            parsed = wire.parse_stereo_request(
                self.headers.get("Content-Type"), self.headers, body)
        except wire.WireRejected as e:
            trace.finish(status="rejected", code=e.code)
            return self._reject(e.http_status, e.code, str(e))
        if (trace is not NULL_TRACE and trace.request_id is None
                and parsed["id"] is not None):
            # The trace opened at the wire, before the body existed; a
            # body-carried id is backfilled so the ring/sink stays
            # grep-able by request id either way. The disabled-tracing
            # singleton is slotted (assignment would raise), so it is
            # skipped — it records nothing to grep anyway.
            trace.request_id = parsed["id"]

        # Decode offload: the acceptor thread submits and waits; the
        # bounded pool does the pixel work (and the bomb guard runs in
        # the pool behind the header parse, before any allocation). The
        # two images are SEPARATE tasks: one combined task would
        # serialize two decodes even with an idle worker.
        t0 = time.monotonic()
        try:
            futs = tuple(
                fe.decode_pool.submit(wire.decode_canonical, data, name,
                                      fe.decode_max_pixels)
                for name, data in (("left", parsed["left"]),
                                   ("right", parsed["right"])))
        except RuntimeError:
            # stop() shut the pool down between this handler's body read
            # and its decode submit: a structured late-drain response,
            # not a handler crash.
            trace.finish(status="rejected", code="service_stopped")
            return self._reject(
                503, "service_stopped",
                "ingress stopped before decode could be scheduled",
                headers={"Retry-After": "1"})
        try:
            with trace.span("decode"):
                left, right = (f.result(timeout=DECODE_WAIT_S)
                               for f in futs)
        except wire.WireRejected as e:
            for f in futs:
                f.cancel()
            trace.finish(status="rejected", code=e.code)
            return self._reject(e.http_status, e.code, str(e))
        except FuturesTimeout:
            for f in futs:
                f.cancel()
            trace.finish(status="rejected", code="decode_timeout")
            return self._reject(
                503, "decode_timeout",
                "decode pool backlogged past its wait bound",
                headers={"Retry-After": "1"})
        except Exception as e:  # noqa: BLE001 — hostile-bytes boundary
            for f in futs:
                f.cancel()
            trace.finish(status="rejected", code="bad_image")
            return self._reject(400, "bad_image",
                                f"decode failed: {type(e).__name__}: {e}")
        fe.decode_hist.observe(time.monotonic() - t0)

        # The sanitized tenant key joins the request here and rides it
        # through admission into the scheduler rows — per-tenant device
        # seconds, outcome counters and the /debug/usage rollup all key
        # on it (obs/usage.py).
        request = {"id": parsed["id"], "left": left, "right": right,
                   "tenant": tenant, "_trace": trace}
        if parsed["deadline_ms"] is not None:
            request["deadline_ms"] = parsed["deadline_ms"]
        # graftstream session affinity: keep-alive POSTs carrying one
        # X-Raft-Session value form a stream — consecutive frames land
        # in the same (tenant, session) slot and warm-start.  The id is
        # sanitized by the StreamManager with the same bounded-label
        # discipline as tenants, so hostile session-name churn cannot
        # grow memory or /metrics (the table is LRU+TTL bounded).
        stream_id = self.headers.get("X-Raft-Session")
        if stream_id:
            request["stream"] = stream_id
        if parsed["converge_tol"] is not None:
            request["converge_tol"] = parsed["converge_tol"]
        tenant_count("admitted")
        try:
            resp = fe.service.submit(request).result(
                timeout=RESPONSE_WAIT_S)
        except FuturesTimeout:
            # The service contract (supervision) resolves every
            # Future; this bound exists so even a contract violation
            # costs one structured 500, never a permanently pinned
            # acceptor thread. Finish the trace explicitly: the service
            # never saw the Future resolve, so nobody else will record
            # the single most diagnostic timeline in the ring.
            trace.finish(status="error", code="ingress_timeout")
            return self._reject(
                500, "ingress_timeout",
                f"no service response within {RESPONSE_WAIT_S:.0f}s")
        status = wire.http_status_for(resp)
        retry_after = wire.retry_after_for(resp)
        payload = wire.encode_response(resp)
        fe.service.session.usage.add_bytes(
            fe.service.session.usage.label(tenant), n_out=len(payload))
        self._send_json(
            status, payload,
            code_label=("ok" if resp.get("status") == "ok"
                        else str(resp.get("code", "unknown"))),
            headers=({"Retry-After": str(retry_after)}
                     if retry_after is not None else None))


class _IngressServer(ThreadingHTTPServer):
    """Thread-per-connection listener with quiet, counted error
    handling: a client that vanishes mid-parse is routine (counted as a
    disconnect), anything else is a counted crash with a traceback —
    never a silent dead thread.

    Connections are capped by a semaphore (``HttpConfig.max_connections``
    slots, stamped by :class:`HttpFrontend`): every per-connection
    defense (read timeout, body deadline) bounds ONE connection, so
    without an aggregate cap an attacker holding many sockets open just
    inside those deadlines would pin unbounded handler threads. A
    connection over the cap costs one minimal 503 ``overloaded`` write
    on the acceptor thread, never a handler thread."""

    daemon_threads = True
    allow_reuse_address = True
    frontend: "HttpFrontend" = None  # type: ignore[assignment]
    conn_slots: threading.Semaphore = None  # type: ignore[assignment]

    _OVERLOADED_BODY = json.dumps(
        {"status": "rejected", "code": "overloaded",
         "message": "concurrent-connection limit reached"}).encode()
    _OVERLOADED_RESPONSE = (
        b"HTTP/1.1 503 Service Unavailable\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: " + str(len(_OVERLOADED_BODY)).encode() +
        b"\r\nRetry-After: 1\r\nConnection: close\r\n\r\n" +
        _OVERLOADED_BODY)

    def process_request(self, request, client_address):
        if not self.conn_slots.acquire(blocking=False):
            try:
                request.sendall(self._OVERLOADED_RESPONSE)
            except OSError:
                pass
            finally:
                self.frontend.registry.counter(
                    "raft_http_responses_total",
                    "HTTP responses by status and structured code",
                    status="503", code="overloaded").inc()
                self.shutdown_request(request)
            return
        try:
            super().process_request(request, client_address)
        except BaseException:
            self.conn_slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self.conn_slots.release()

    def handle_error(self, request, client_address):
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, socket.timeout,
                            TimeoutError, BrokenPipeError)):
            logger.debug("connection error from %s: %s",
                         client_address, exc)
            return
        self.frontend.registry.counter(
            "raft_http_handler_crashes_total",
            "unexpected exceptions escaping request routing").inc()
        logger.exception("unhandled error on connection from %s",
                         client_address)


class HttpFrontend:
    """The listener + decode pool + quota state around one
    :class:`~raft_stereo_tpu_torch.serve.service.StereoService`.

    Construction binds the socket (so ``port`` is final — ephemeral
    ``port=0`` included — before :meth:`start` spawns the serve loop);
    ``stop()`` stops accepting, closes the listener and tears down the
    decode pool. Draining is the SERVICE's state: call
    ``service.begin_drain()`` / ``service.drain()`` and this frontend
    starts answering 503 ``service_draining`` through the very same
    submit path in-process callers see.
    """

    def __init__(self, service, cfg: Optional[HttpConfig] = None):
        # Function-scope import, as the JAX copy's: the serving package
        # imports without the data modules.
        from raft_stereo_tpu_torch.data.frame_utils import \
            resolve_decode_max_pixels
        self.service = service
        self.cfg = cfg or HttpConfig()
        self.registry = service.registry
        self.body_max = resolve_body_max(self.cfg.body_max)
        self.read_timeout_s = resolve_read_timeout_ms(
            self.cfg.read_timeout_ms) / 1e3
        self.body_deadline_s = self.read_timeout_s * BODY_DEADLINE_FACTOR
        self.decode_max_pixels = resolve_decode_max_pixels(
            self.cfg.decode_max_pixels)
        self.quotas = TenantQuotas(
            resolve_tenant_rate(self.cfg.tenant_rate),
            max_tenants=self.cfg.max_tenants)
        self.decode_pool = ThreadPoolExecutor(
            max_workers=max(1, self.cfg.decode_workers),
            thread_name_prefix="stereo-decode")
        self.decode_hist = self.registry.histogram(
            "raft_http_decode_seconds",
            "offloaded image-decode latency (bounded reservoir)",
            reservoir=512)
        handler = type("BoundIngressHandler", (_IngressHandler,), {
            "frontend": self,
            "timeout": self.read_timeout_s,  # per-read socket timeout
        })
        self._server = _IngressServer(
            (self.cfg.host, resolve_http_port(self.cfg.port)), handler)
        self._server.frontend = self
        self._server.conn_slots = threading.Semaphore(
            max(1, self.cfg.max_connections))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def host(self) -> str:
        return self._server.server_address[0]

    def start(self) -> "HttpFrontend":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="stereo-http-listener", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting (the drain contract's final step), close the
        listening socket, tear down the decode pool. In-flight handler
        threads finish their current responses (a handler losing the
        race to the pool shutdown gets a structured 503
        ``service_stopped``, never a crash)."""
        t = self._thread
        if t is not None:
            # BaseServer.shutdown() blocks on an event only
            # serve_forever() sets — calling it when start() never ran
            # (e.g. an embedder's finally between construction and
            # start) would deadlock forever.
            self._server.shutdown()
        self._server.server_close()
        self.decode_pool.shutdown(wait=False)
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _ingress_block(self) -> Dict:
        return {
            "endpoint": f"{self.host}:{self.port}",
            "body_max_bytes": self.body_max,
            "read_timeout_ms": self.read_timeout_s * 1e3,
            "body_deadline_ms": self.body_deadline_s * 1e3,
            "decode_workers": self.cfg.decode_workers,
            "decode_max_pixels": self.decode_max_pixels,
            "max_connections": self.cfg.max_connections,
            "quota": self.quotas.status(),
        }

    def status_doc(self) -> Dict:
        """The /healthz body: the service's own status document plus the
        ingress block (the wire-side numbers an operator tunes)."""
        doc = self.service.status()
        doc["ingress"] = self._ingress_block()
        return doc

    # -- operator-plane debug endpoints (graftdeck, DESIGN.md r15) ---------

    def debug_ticks_doc(self, raw_path: str = "") -> Dict:
        """GET /debug/ticks: the tick flight-deck ring (bounded by the
        ring size; ``?n=<k>`` bounds it further)."""
        from urllib.parse import parse_qs
        n = None
        query = raw_path.partition("?")[2]
        if query:
            raw_n = (parse_qs(query, keep_blank_values=False)
                     .get("n", [None])[0])
            if raw_n is not None:
                try:
                    n = max(1, int(raw_n))
                except ValueError:
                    n = None  # a hostile ?n= is ignored, never a 500
        return self.service.session.deck.doc(n)

    def debug_config_doc(self) -> Dict:
        """GET /debug/config: the resolved-knob snapshot an operator
        diffs against what they THINK is deployed — session + service +
        ingress config, fingerprint, breaker trips, batch-bucket
        ladder, program-cache contents.  Read-only and bounded."""
        svc = self.service
        doc = svc.session.config_doc()
        doc["schema"] = 1
        doc["service_cfg"] = dataclasses.asdict(svc.cfg)
        doc["ingress"] = self._ingress_block()
        return doc
