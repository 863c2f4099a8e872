"""The port's HTTP ingress (serve/http.py) and wire codec (serve/wire.py)
on the CPU, over real loopback sockets.

Mirrors the JAX package's battery (tests/test_http.py) with its tiny model
and ``device="cpu"``: the codec units, the decompression-bomb guard at the
file path and at the wire, the knob resolvers and tenant quotas, the
malformed-request battery with one stable code per case and the acceptor
surviving it, loopback parity with in-process ``submit``, quotas over the
wire, the drain, ingress spans, and the CLI (``python -m
raft_stereo_tpu_torch.serve_stereo``): mode validation, the decode
prefetch, the readiness handshake and the SIGTERM drain.

In addition, both packages' copies side by side: ``encode_response``,
``parse_multipart`` and the status table give equal bytes and codes, and a
crafted PNG over ``RAFT_DECODE_MAX_PIXELS`` raises ``ImageTooLarge`` from
both packages' ``read_image_rgb`` and from the port's demo reader.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_stereo_tpu.data import frame_utils as jax_frame_utils
from raft_stereo_tpu.serve import wire as jax_wire

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch import demo as port_demo
from raft_stereo_tpu_torch.data.frame_utils import (ImageTooLarge, read_image_rgb,
                                                    resolve_decode_max_pixels)
from raft_stereo_tpu_torch.faults import WIRE_FAULT_KINDS, WireChaosPlan, bomb_png
from raft_stereo_tpu_torch.serve import (HttpConfig, HttpFrontend, InferenceSession,
                                         ServiceConfig, SessionConfig, StereoService)
from raft_stereo_tpu_torch.serve import wire
from raft_stereo_tpu_torch.serve.http import (TenantQuotas, _TokenBucket, resolve_body_max,
                                              resolve_read_timeout_ms, resolve_tenant_rate,
                                              sanitize_tenant)

pytestmark = pytest.mark.http

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32),
            corr_levels=2, corr_radius=2)
H, W = 40, 60


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def png_pair(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    right = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    return left, right


# ---------------------------------------------------------------------------
# Codec units (no server)
# ---------------------------------------------------------------------------


def test_multipart_roundtrip():
    ct, body = wire.build_multipart({"left": b"L" * 100, "right": b"R" * 7,
                                     "id": b"x-1"})
    media, params = wire.parse_content_type(ct)
    assert media == "multipart/form-data"
    parts = wire.parse_multipart(body, params["boundary"])
    assert parts == {"left": b"L" * 100, "right": b"R" * 7, "id": b"x-1"}


@pytest.mark.parametrize("mangle", [
    lambda b: b[:len(b) // 2],            # truncated mid-part
    lambda b: b[:-6],                     # closing terminator cut
    lambda b: b"junk" + b,                # does not open with boundary
    lambda b: b.replace(b"--raftwire\r\n", b"--raftwire..", 1),
    #                                     ^ delimiter without its CRLF
])
def test_multipart_strict_rejects(mangle):
    _, body = wire.build_multipart({"left": b"LL", "right": b"RR"})
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_multipart(mangle(body), "raftwire")
    assert exc.value.code == "bad_multipart"


def test_multipart_no_boundary_param():
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_stereo_request("multipart/form-data", {}, b"--x\r\n")
    assert exc.value.code == "bad_multipart"


def test_raw_pair_framing():
    body = b"LEFTBYTES" + b"RIGHT"
    headers = {"X-Raft-Left-Len": "9", "X-Raft-Right-Len": "5",
               "X-Raft-Id": "r-0", "X-Raft-Deadline-Ms": "1500"}
    req = wire.parse_stereo_request(
        "application/x-raft-stereo", headers, body)
    assert req["left"] == b"LEFTBYTES" and req["right"] == b"RIGHT"
    assert req["id"] == "r-0" and req["deadline_ms"] == 1500.0


@pytest.mark.parametrize("headers,code", [
    ({}, "missing_part"),
    ({"X-Raft-Left-Len": "nine", "X-Raft-Right-Len": "5"},
     "bad_part_lengths"),
    ({"X-Raft-Left-Len": "-1", "X-Raft-Right-Len": "15"},
     "bad_part_lengths"),
    ({"X-Raft-Left-Len": "9", "X-Raft-Right-Len": "99"},
     "bad_part_lengths"),  # declared split != body (truncated upload)
])
def test_raw_pair_bad_framing(headers, code):
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_stereo_request("application/x-raft-stereo", headers,
                                  b"LEFTBYTESRIGHT")
    assert exc.value.code == code


def test_unsupported_media_type_and_empty_body():
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_stereo_request("text/plain", {}, b"hello")
    assert exc.value.code == "unsupported_media_type"
    assert exc.value.http_status == 415
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_stereo_request("multipart/form-data", {}, b"")
    assert exc.value.code == "empty_body"


@pytest.mark.parametrize("raw", [b"soon", b"nan", b"inf", b"-inf"])
def test_bad_deadline_rejected(raw):
    # float() accepts "nan"/"inf" — a NaN deadline silently disables the
    # deadline machinery (every now-vs-deadline comparison is False), so
    # non-finite values are bad_deadline like any other garbage.
    ct, body = wire.build_multipart({"left": b"L", "right": b"R",
                                     "deadline_ms": raw})
    with pytest.raises(wire.WireRejected) as exc:
        wire.parse_stereo_request(ct, {}, body)
    assert exc.value.code == "bad_deadline"


def test_response_contract_survives_the_wire():
    """The response contract — quality labels, structured errors,
    ``retries: k`` — serializes unchanged, disparity bit-exact."""
    disp = np.linspace(-3, 7, 24, dtype=np.float32).reshape(1, 4, 6)
    resp = {"status": "ok", "id": "q-7", "quality": "reduced_iters:16",
            "retries": 2, "elapsed_ms": 12.5, "disparity": disp}
    back = wire.decode_response(wire.encode_response(resp))
    assert back["status"] == "ok" and back["id"] == "q-7"
    assert back["quality"] == "reduced_iters:16" and back["retries"] == 2
    assert back["disparity"].dtype == np.float32
    assert back["disparity"].tobytes() == disp.tobytes()

    rej = {"status": "rejected", "code": "queue_full", "message": "full"}
    assert wire.decode_response(wire.encode_response(rej)) == rej


@pytest.mark.parametrize("resp,status,retry_after", [
    ({"status": "ok"}, 200, None),
    ({"status": "error", "code": "nonfinite_output"}, 500, None),
    ({"status": "rejected", "code": "queue_full"}, 503, 1),
    ({"status": "rejected", "code": "service_draining"}, 503, 5),
    ({"status": "rejected", "code": "quota_exceeded"}, 429, 1),
    ({"status": "rejected", "code": "deadline_exceeded"}, 504, None),
    ({"status": "rejected", "code": "invalid_input:too_large"}, 400, None),
])
def test_status_mapping(resp, status, retry_after):
    assert wire.http_status_for(resp) == status
    assert wire.retry_after_for(resp) == retry_after


def test_decode_image_garbage_and_bomb():
    with pytest.raises(wire.WireRejected) as exc:
        wire.decode_image_rgb(b"\x89PNG but not really", "left")
    assert exc.value.code == "bad_image" and exc.value.http_status == 400
    # 64 MP: above OUR cap (32 MP default), below PIL's own tripwire —
    # the registered-knob guard is what fires
    with pytest.raises(wire.WireRejected) as exc:
        wire.decode_image_rgb(bomb_png(8_000, 8_000), "left")
    assert exc.value.code == "image_too_large"
    assert exc.value.http_status == 413
    assert "8000x8000" in str(exc.value)
    # 400 MP: lands in PIL's DecompressionBombError inside open() —
    # folded into the SAME stable code, not a second error contract
    with pytest.raises(wire.WireRejected) as exc:
        wire.decode_image_rgb(bomb_png(20_000, 20_000), "left")
    assert exc.value.code == "image_too_large"
    assert exc.value.http_status == 413


def test_wire_chaos_plan_seeded_deterministic():
    a = WireChaosPlan.seeded(7, 64)
    b = WireChaosPlan.seeded(7, 64)
    assert a.faults == b.faults
    # Every hostile kind appears before any repeats — a small storm still
    # exercises the full fault surface.
    kinds = set(a.faults.values())
    assert kinds == set(k for k in WIRE_FAULT_KINDS if k != "ok")
    assert WireChaosPlan.seeded(8, 64).faults != a.faults


# ---------------------------------------------------------------------------
# Decompression-bomb guard at the file path
# ---------------------------------------------------------------------------


def test_read_image_rgb_bomb_guard(tmp_path):
    """A crafted PNG declaring 400 MP from a
    few hundred file bytes must die on the header, stable code
    ``image_too_large`` — never a ~1.2 GB allocation."""
    for side in (8_000, 20_000):  # our guard / PIL's own tripwire
        p = tmp_path / f"bomb{side}.png"
        p.write_bytes(bomb_png(side, side))
        assert p.stat().st_size < 1024  # the whole point: tiny file
        with pytest.raises(ImageTooLarge) as exc:
            read_image_rgb(p)
        assert exc.value.code == "image_too_large"


def test_read_image_rgb_legit_passes(tmp_path):
    left, _ = png_pair(8, 12)
    p = tmp_path / "ok.png"
    p.write_bytes(wire.encode_image_png(left))
    assert np.array_equal(read_image_rgb(p), left)


def test_resolve_decode_max_pixels(monkeypatch):
    assert resolve_decode_max_pixels(123) == 123
    monkeypatch.setenv("RAFT_DECODE_MAX_PIXELS", "4096")
    assert resolve_decode_max_pixels() == 4096
    monkeypatch.setenv("RAFT_DECODE_MAX_PIXELS", "many")
    with pytest.raises(ValueError, match="RAFT_DECODE_MAX_PIXELS"):
        resolve_decode_max_pixels()


# ---------------------------------------------------------------------------
# Knob resolvers + tenant quota state (no server)
# ---------------------------------------------------------------------------


def test_http_knob_resolvers_named_errors(monkeypatch):
    monkeypatch.setenv("RAFT_HTTP_BODY_MAX", "1048576")
    assert resolve_body_max() == 1 << 20
    monkeypatch.setenv("RAFT_HTTP_BODY_MAX", "big")
    with pytest.raises(ValueError, match="RAFT_HTTP_BODY_MAX"):
        resolve_body_max()
    monkeypatch.setenv("RAFT_HTTP_READ_TIMEOUT_MS", "250")
    assert resolve_read_timeout_ms() == 250.0
    monkeypatch.setenv("RAFT_HTTP_READ_TIMEOUT_MS", "fast")
    with pytest.raises(ValueError, match="RAFT_HTTP_READ_TIMEOUT_MS"):
        resolve_read_timeout_ms()


def test_resolve_tenant_rate(monkeypatch):
    assert resolve_tenant_rate("10") == (10.0, 10.0)
    assert resolve_tenant_rate("2.5:40") == (2.5, 40.0)
    monkeypatch.setenv("RAFT_TENANT_RATE", "8:16")
    assert resolve_tenant_rate() == (8.0, 16.0)
    monkeypatch.delenv("RAFT_TENANT_RATE")
    assert resolve_tenant_rate() is None
    for bad in ("lots", "0", "-3", "5:0.2"):
        with pytest.raises(ValueError, match="RAFT_TENANT_RATE"):
            resolve_tenant_rate(bad)


def test_sanitize_tenant():
    assert sanitize_tenant(None) == "default"
    assert sanitize_tenant("team-a.prod_2") == "team-a.prod_2"
    assert sanitize_tenant('ev"il\r\nheader{}') == "ev_il__header__"
    assert len(sanitize_tenant("x" * 500)) == 64


def test_token_bucket_exact():
    """Quota exactness on synthetic time: burst admits exactly ``burst``,
    refill admits exactly ``rate`` per second, never above burst."""
    b = _TokenBucket(rate=2.0, burst=3.0, now=100.0)
    assert [b.consume(100.0) for _ in range(5)] == [
        True, True, True, False, False]
    assert b.consume(100.5) is True      # 0.5 s -> exactly one token
    assert b.consume(100.5) is False
    assert [b.consume(200.0) for _ in range(4)] == [
        True, True, True, False]         # refill capped at burst


def test_tenant_quotas_lru_bounded():
    q = TenantQuotas((1.0, 1.0), max_tenants=4)
    for i in range(100):
        q.admit(f"t{i}")
    assert q.status()["tenants_tracked"] <= 4
    assert TenantQuotas(None).admit("anyone") is True


def test_tenant_quota_churn_cannot_reset_spent_bucket():
    """Regression: churning fresh tenant names past max_tenants used to
    LRU-evict a spent bucket, so a blown tenant got a full burst back
    every ~max_tenants cheap requests. Eviction is now lossless-only
    (full buckets), spent buckets survive churn, newcomers share one
    overflow bucket."""
    q = TenantQuotas((0.001, 2.0), max_tenants=4)  # negligible refill
    assert q.admit("evil") and q.admit("evil")     # burst spent
    assert q.admit("evil") is False
    for t in ("a", "b", "c"):                      # fill the map
        q.admit(t)
    churn = [q.admit(f"churn{i}") for i in range(10)]
    # no tracked bucket is refilled-to-full -> every churn tenant shares
    # the ONE overflow bucket: exactly its burst admits, then denial
    assert churn == [True, True] + [False] * 8
    assert q.status()["overflow_bucket_active"]
    assert q.admit("evil") is False, "churn refilled a spent bucket"
    assert q.status()["tenants_tracked"] <= 4


def test_tenant_quota_lossless_eviction_of_idle_bucket():
    """A bucket that has refilled to full burst IS evictable — dropping
    it is lossless (re-creation starts full), so genuinely new tenants
    still get tracked slots as old ones go idle."""
    q = TenantQuotas((1.0, 2.0), max_tenants=2)
    q.admit("old")
    q.admit("recent")
    with q._lock:  # simulate 'old' idling long enough to refill fully
        q._buckets["old"].t_last -= 60.0
        q._buckets["recent"].tokens = 0.0
    assert q.admit("new") is True
    assert "old" not in q._buckets and "recent" in q._buckets
    assert q.status()["overflow_bucket_active"] is False


def test_tenant_label_set_bounded():
    """Metric labels: first max_tenants distinct names keep their own
    label, later names share __other__ — the registry keeps every label
    combination forever, so hostile name churn must not mint new ones
    (quota configured or not)."""
    q = TenantQuotas(None, max_tenants=2)
    assert q.label("a") == "a" and q.label("b") == "b"
    assert q.label("c") == TenantQuotas.OVERFLOW_LABEL
    assert q.label("a") == "a"  # established labels stay stable


# ---------------------------------------------------------------------------
# Live loopback battery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def session(tiny_cfg):
    model = init_raft_stereo(tiny_cfg, seed=0, device="cpu")
    return InferenceSession(
        model, tiny_cfg,
        SessionConfig(valid_iters=4, segments=2,
                      warmup_shapes=((H, W),), warmup_segmented=True),
        device="cpu")


@pytest.fixture(scope="module")
def service(session):
    svc = StereoService(session, ServiceConfig(max_queue=8)).start()
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def frontend(service):
    with HttpFrontend(service, HttpConfig(port=0)) as fe:
        yield fe


def post(fe, ct, body, headers=None, path="/v1/stereo"):
    """Well-formed-enough client: returns (status, headers, doc)."""
    req = urllib.request.Request(
        f"http://{fe.host}:{fe.port}{path}", data=body, method="POST",
        headers={"Content-Type": ct, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), wire.decode_response(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def raw_exchange(fe, data: bytes, timeout=10.0, half_close=False):
    """Fully hostile client: raw bytes out, (status, doc) parsed from
    whatever comes back before the server closes the connection."""
    with socket.create_connection((fe.host, fe.port),
                                  timeout=timeout) as s:
        s.sendall(data)
        if half_close:
            s.shutdown(socket.SHUT_WR)
        chunks = []
        try:
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
        except (socket.timeout, TimeoutError):
            pass
    raw = b"".join(chunks)
    assert raw.startswith(b"HTTP/1."), raw[:80]
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, (json.loads(body) if body.strip() else {})


def stereo_request_bytes(ct, body, extra_headers=()):
    head = (f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: {ct}\r\nContent-Length: {len(body)}\r\n")
    for k, v in extra_headers:
        head += f"{k}: {v}\r\n"
    return head.encode("latin-1") + b"\r\n" + body


def good_multipart(h=H, w=W, seed=0, rid=b"wire-0"):
    left, right = png_pair(h, w, seed)
    return wire.build_multipart({
        "left": wire.encode_image_png(left),
        "right": wire.encode_image_png(right), "id": rid}), (left, right)


def crash_count(fe) -> int:
    return sum(int(v) for _, v in
               fe.registry.series("raft_http_handler_crashes_total"))


def test_loopback_parity_mixed_shapes(service, frontend):
    """A mixed-shape request set over real sockets is
    byte-identical (disparity) and outcome-identical to the same set
    through ``StereoService.submit`` in-process."""
    # (44, 36) shares the warmed (40, 60) pad bucket; (72, 40) forces a
    # second bucket — "mixed-shape" covers both request AND program
    # diversity without a third compile.
    shapes = [(H, W), (44, 36), (72, 40), (H, W)]
    for i, (h, w) in enumerate(shapes):
        left, right = png_pair(h, w, seed=10 + i)
        (ct, body), _ = good_multipart(h, w, seed=10 + i,
                                       rid=f"par-{i}".encode())
        status, headers, over_wire = post(frontend, ct, body)
        assert status == 200, over_wire
        in_proc = service.submit({
            "id": f"par-{i}",
            "left": left.astype(np.float32)[None],
            "right": right.astype(np.float32)[None]}).result(timeout=600)
        assert in_proc["status"] == "ok"
        assert over_wire["status"] == "ok"
        assert over_wire["quality"] == in_proc["quality"]
        assert over_wire.get("retries", 0) == in_proc.get("retries", 0)
        assert over_wire["disparity"].tobytes() == \
            np.asarray(in_proc["disparity"], np.float32).tobytes()
        assert over_wire["id"] == in_proc["id"]


def test_hostile_battery_one_code_each(frontend):
    """The malformed-request battery — one stable structured
    code per case, acceptor alive after ALL of them (proven by a clean
    200 at the end and a zero crash counter)."""
    crashes0 = crash_count(frontend)
    (ct, body), _ = good_multipart()
    boundary = ct.split("boundary=")[1]

    # (request bytes or callable, expected status, expected code)
    cases = []

    # empty body
    cases.append((stereo_request_bytes(ct, b""), 400, "empty_body"))
    # wrong content-type
    cases.append((stereo_request_bytes("text/plain", b"hi"), 415,
                  "unsupported_media_type"))
    # oversize declared content-length: rejected BEFORE any body bytes
    big = frontend.body_max + 1
    cases.append((
        f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\nContent-Type: {ct}\r\n"
        f"Content-Length: {big}\r\n\r\n".encode(), 413, "body_too_large"))
    # absurd but non-numeric content-length
    cases.append((
        f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\nContent-Type: {ct}\r\n"
        f"Content-Length: lots\r\n\r\n".encode(), 400,
        "bad_content_length"))
    # no content-length at all
    cases.append((
        f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
        f"Content-Type: {ct}\r\n\r\n".encode(), 411, "length_required"))
    # truncated body: declared full length, half sent, then half-close
    cases.append((stereo_request_bytes(ct, body)[:-len(body) // 2], 400,
                  "truncated_body"))
    # truncated multipart: consistent lengths, framing cut short
    cut = body[:-8]
    cases.append((stereo_request_bytes(ct, cut), 400, "bad_multipart"))
    # missing part
    _, only_left = wire.build_multipart({"left": b"x"}, boundary=boundary)
    cases.append((stereo_request_bytes(ct, only_left), 400,
                  "missing_part"))
    # garbage image bytes
    _, garb = wire.build_multipart(
        {"left": b"not a png", "right": b"also no"}, boundary=boundary)
    cases.append((stereo_request_bytes(ct, garb), 400, "bad_image"))
    # decompression bomb: 400 MP declared in ~300 file bytes
    _, bomb = wire.build_multipart(
        {"left": bomb_png(20_000, 20_000),
         "right": bomb_png(20_000, 20_000)}, boundary=boundary)
    cases.append((stereo_request_bytes(ct, bomb), 413, "image_too_large"))
    # unknown route / wrong method
    cases.append((stereo_request_bytes(ct, body).replace(
        b"/v1/stereo", b"/v1/nope", 1), 404, "unknown_route"))
    cases.append((stereo_request_bytes(ct, body).replace(
        b"POST", b"DELETE", 1), 405, "method_not_allowed"))
    # header flood: stdlib parser caps at 100 header lines -> JSON 431
    flood = (b"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
             + b"".join(b"X-Flood-%d: y\r\n" % i for i in range(150))
             + b"\r\n")
    cases.append((flood, 431, "too_many_headers"))
    # bad deadline via header on an otherwise good request
    cases.append((stereo_request_bytes(
        ct, body, extra_headers=[("X-Raft-Deadline-Ms", "soon")]), 400,
        "bad_deadline"))

    for i, (data, want_status, want_code) in enumerate(cases):
        status, doc = raw_exchange(frontend, data, half_close=True)
        assert status == want_status, (i, want_code, status, doc)
        assert doc.get("code") == want_code, (i, doc)
        assert doc.get("status") in ("rejected", "error"), (i, doc)

    # The acceptor survived every case: zero crashes, and a well-formed
    # request right after the storm still serves.
    assert crash_count(frontend) == crashes0
    status, _, doc = post(frontend, ct, body)
    assert status == 200 and doc["status"] == "ok"


def _responses_total(fe) -> int:
    return sum(int(v) for _, v in
               fe.registry.series("raft_http_responses_total"))


def test_client_disconnect_mid_response_survives(frontend):
    """A client that sends a full request then vanishes without reading
    the response still gets exactly ONE accounting entry ('ok' if the
    write landed in the dead socket's buffer, 'client_disconnect' if it
    didn't), and the listener keeps serving throughout."""
    before = _responses_total(frontend)
    (ct, body), _ = good_multipart(seed=3)
    with socket.create_connection((frontend.host, frontend.port),
                                  timeout=10) as s:
        s.sendall(stereo_request_bytes(ct, body))
        # close immediately: the response write hits a dead socket
    deadline = time.monotonic() + 120
    while _responses_total(frontend) == before:
        assert time.monotonic() < deadline, (
            "abandoned request never produced an accounting entry")
        # the in-flight request finishes asynchronously; poll healthz to
        # prove the listener keeps serving while it does
        status, _, _ = get(frontend, "/healthz")
        assert status == 200
        time.sleep(0.1)
    assert _responses_total(frontend) >= before + 1
    (ct, body), _ = good_multipart(seed=4)
    status, _, doc = post(frontend, ct, body)
    assert status == 200 and doc["status"] == "ok"


def test_stalled_body_evicted(service):
    """Slow-loris defense: a client that stalls mid-body is answered 408
    within the read deadline — the acceptor thread is never pinned."""
    with HttpFrontend(service, HttpConfig(
            port=0, read_timeout_ms=200.0)) as fe:
        (ct, body), _ = good_multipart(seed=5)
        head = stereo_request_bytes(ct, body)[:-len(body)]  # headers only
        t0 = time.monotonic()
        with socket.create_connection((fe.host, fe.port), timeout=30) as s:
            s.sendall(head + body[:100])  # 100 of len(body) bytes, then
            s.settimeout(30)              # silence — NOT a close
            chunks = []
            try:
                while True:
                    b = s.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
            except (socket.timeout, TimeoutError):
                pass
        elapsed = time.monotonic() - t0
        raw = b"".join(chunks)
        assert b" 408 " in raw.split(b"\r\n", 1)[0], raw[:80]
        assert json.loads(raw.partition(b"\r\n\r\n")[2])["code"] == \
            "read_timeout"
        # 8 deadline factor x 0.2 s = 1.6 s worst case, plus slack
        assert elapsed < 10.0


def test_trickling_body_hits_whole_body_deadline(service):
    """The OTHER slow-loris: a client trickling bytes just under the
    per-read timeout never trips it — the whole-body deadline
    (BODY_DEADLINE_FACTOR read-timeouts) must evict it anyway. Guards
    the read1-per-recv regression: a buffered read(n) would absorb the
    trickle for one byte per recv and hold the thread ~forever."""
    with HttpFrontend(service, HttpConfig(
            port=0, read_timeout_ms=150.0)) as fe:
        (ct, body), _ = good_multipart(seed=11)
        head = stereo_request_bytes(ct, body)[:-len(body)]
        t0 = time.monotonic()
        raw = b""
        with socket.create_connection((fe.host, fe.port), timeout=30) as s:
            s.sendall(head)
            s.setblocking(False)
            sent = 0
            while time.monotonic() - t0 < 10.0:
                try:
                    raw += s.recv(65536)
                    if b"\r\n\r\n" in raw and raw.rstrip().endswith(b"}"):
                        break  # server answered: stop trickling
                except BlockingIOError:
                    pass
                if sent < len(body):
                    try:
                        s.send(body[sent:sent + 1])  # one byte per tick
                        sent += 1
                    except BlockingIOError:
                        pass
                time.sleep(0.05)  # well under the 150 ms per-read timeout
        elapsed = time.monotonic() - t0
        assert b" 408 " in raw.split(b"\r\n", 1)[0], raw[:120]
        assert json.loads(raw.partition(b"\r\n\r\n")[2])["code"] == \
            "read_timeout"
        # deadline = 8 x 0.15 s = 1.2 s; well before the trickle would
        # have delivered the full body
        assert 1.0 <= elapsed < 8.0, elapsed


def test_tenant_quota_exact_over_wire(service):
    """Per-tenant token buckets keyed by X-Raft-Tenant: burst admits
    exactly ``burst`` requests, the next is 429 + Retry-After, and an
    unrelated tenant is untouched."""
    with HttpFrontend(service, HttpConfig(
            port=0, tenant_rate="0.000001:2")) as fe:
        outcomes = []
        for i in range(4):
            (ct, body), _ = good_multipart(seed=6)
            status, headers, doc = post(
                fe, ct, body, headers={"X-Raft-Tenant": "hog"})
            outcomes.append((status, doc.get("code")))
        assert outcomes[:2] == [(200, None), (200, None)], outcomes
        assert outcomes[2:] == [(429, "quota_exceeded")] * 2, outcomes
        # the 429 told the client when to come back
        (ct, body), _ = good_multipart(seed=7)
        status, headers, doc = post(
            fe, ct, body, headers={"X-Raft-Tenant": "hog"})
        assert status == 429 and "Retry-After" in headers
        # quota is per tenant, not global
        status, _, doc = post(fe, ct, body,
                              headers={"X-Raft-Tenant": "polite"})
        assert status == 200 and doc["status"] == "ok"
        # exactness in the metrics: admitted == 2, quota_exceeded == 3
        by_outcome = {(labels["tenant"], labels["outcome"]): int(v)
                      for labels, v in fe.registry.series(
                          "raft_http_tenant_requests_total")}
        assert by_outcome[("hog", "admitted")] == 2
        assert by_outcome[("hog", "quota_exceeded")] == 3
        assert by_outcome[("polite", "admitted")] == 1


def test_drain_answers_503_service_draining(session):
    """SIGTERM semantics at the wire: a draining service answers late
    wire requests 503 ``service_draining`` + Retry-After through the SAME
    submit path in-process callers see, then quiesces clean."""
    svc = StereoService(session, ServiceConfig(max_queue=4)).start()
    with HttpFrontend(svc, HttpConfig(port=0)) as fe:
        svc.begin_drain()
        (ct, body), _ = good_multipart(seed=8)
        status, headers, doc = post(fe, ct, body)
        assert status == 503 and doc["code"] == "service_draining"
        assert headers.get("Retry-After")
        assert svc.drain() is True


def test_ingress_spans_join_the_service_timeline(service, frontend):
    """The trace opens at the WIRE: one timeline carries ingress_read and
    decode (frontend) ahead of admission/queue_wait (service) — not two
    disjoint traces stitched by a reader."""
    (ct, body), _ = good_multipart(seed=9, rid=b"span-probe")
    status, _, doc = post(frontend, ct, body)
    assert status == 200 and doc["status"] == "ok"
    probe = [t for t in service.tracer.timelines()
             if t.get("request_id") == "span-probe"]
    assert probe, "served request left no trace in the ring"
    kinds = [s["kind"] for s in probe[-1]["spans"]]
    for kind in ("ingress_read", "decode", "admission"):
        assert kind in kinds, (kind, kinds)
    assert kinds.index("ingress_read") < kinds.index("decode") \
        < kinds.index("admission")


def get(fe, path):
    try:
        with urllib.request.urlopen(
                f"http://{fe.host}:{fe.port}{path}", timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_healthz_and_metrics_are_real_endpoints(frontend):
    status, _, body = get(frontend, "/healthz")
    doc = json.loads(body)
    assert status == 200 and doc["ingress"]["endpoint"].endswith(
        str(frontend.port))
    assert doc["ingress"]["quota"]["limit"] is None
    # graftfleet (r20): generation identity + age are TOP-LEVEL fields —
    # the fleet router keys rolling deploys on fingerprint_id from the
    # one endpoint it already polls (not /debug/config) and reads
    # restarts off uptime_s.
    assert doc["fingerprint_id"] == \
        frontend.service.session.fingerprint_id()
    assert isinstance(doc["uptime_s"], float) and doc["uptime_s"] >= 0
    status, headers, body = get(frontend, "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert "raft_http_responses_total" in text
    assert "raft_requests_total" in text  # the service's own registry
    # wrong-method probes get the stable codes
    status, _, doc = post(frontend, "text/plain", b"", path="/healthz")
    assert status == 405 and doc["code"] == "method_not_allowed"
    status, _, body = get(frontend, "/v1/stereo")
    assert status == 405 and json.loads(body)["code"] == \
        "method_not_allowed"


def test_disabled_tracer_id_backfill_is_harmless(frontend, monkeypatch):
    """A body-carried id with tracing disabled must not crash the
    handler: the disabled-tracing singleton is slotted, so the id
    backfill has to skip it (regression: AttributeError -> 500 on every
    id-carrying request)."""
    from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
    monkeypatch.setattr(frontend.service, "tracer", type(
        "T", (), {"start_request": staticmethod(
            lambda rid=None: NULL_TRACE)})())
    before = crash_count(frontend)
    (ct, body), _ = good_multipart(rid=b"null-trace-id")
    status, _, doc = post(frontend, ct, body)
    assert status == 200 and doc["status"] == "ok", doc
    assert crash_count(frontend) == before


def test_stop_without_start_does_not_deadlock(service):
    """stop() on a never-started frontend must return (regression:
    BaseServer.shutdown() blocks on an event only serve_forever() sets,
    so an embedder's finally-cleanup hung forever)."""
    fe = HttpFrontend(service, HttpConfig(port=0))
    t = threading.Thread(target=fe.stop, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "stop() before start() deadlocked"


def test_expect_100_oversize_rejected_before_body(frontend):
    """A client sending ``Expect: 100-continue`` with an over-cap
    Content-Length gets the 413 verdict while still WAITING to send the
    body — no doomed upload is invited with a 100 Continue."""
    huge = frontend.body_max + 1
    head = (f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: multipart/form-data; boundary=x\r\n"
            f"Content-Length: {huge}\r\nExpect: 100-continue\r\n\r\n")
    status, doc = raw_exchange(frontend, head.encode("latin-1"))
    assert status == 413 and doc["code"] == "body_too_large", doc


def test_reject_drains_body_for_structured_answer(frontend):
    """Header-level rejects drain the (bounded) declared body before
    closing: closing with unread receive-buffer data emits TCP RST,
    which can destroy the structured response in flight. A client that
    sent its whole sizeable body to a doomed request must still read
    the JSON verdict."""
    body = b"z" * (128 << 10)
    head = (f"POST /nowhere HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: text/plain\r\n"
            f"Content-Length: {len(body)}\r\n\r\n")
    status, doc = raw_exchange(frontend, head.encode("latin-1") + body)
    assert status == 404 and doc["code"] == "unknown_route", doc


def test_method_message_names_method_and_head_is_bodyless(frontend):
    """405s name the actual method (regression: DELETE answered 'PUT is
    not supported'); HEAD responses are header-only per RFC 9110, and
    HEAD /healthz is the GET twin (LB/uptime probes commonly use HEAD —
    a 405 would rotate a healthy instance out)."""
    status, doc = raw_exchange(
        frontend, b"DELETE /v1/stereo HTTP/1.1\r\nHost: t\r\n\r\n")
    assert status == 405 and "DELETE" in doc["message"], doc
    status, doc = raw_exchange(
        frontend, b"HEAD /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
    assert status == 200 and doc == {}, "HEAD /healthz: headers only"
    status, doc = raw_exchange(
        frontend, b"HEAD /v1/stereo HTTP/1.1\r\nHost: t\r\n\r\n")
    assert status == 405 and doc == {}, "HEAD must carry no body"


def test_get_with_zero_content_length_keeps_keepalive(frontend):
    """``Content-Length: 0`` on a GET is a benign bodyless declaration
    (some clients send it on every request) — it must not be treated as
    a smuggled body and cost a reconnect per keep-alive probe."""
    probe = (b"GET /healthz HTTP/1.1\r\nHost: t\r\n"
             b"Content-Length: 0\r\n\r\n")

    def read_response(s):
        buf = b""
        while b"\r\n\r\n" not in buf:
            b_ = s.recv(65536)
            assert b_, "connection closed on a CL:0 keep-alive GET"
            buf += b_
        head, _, rest = buf.partition(b"\r\n\r\n")
        cl = next(int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                  if ln.lower().startswith(b"content-length"))
        while len(rest) < cl:
            b_ = s.recv(65536)
            assert b_, "connection closed mid-body"
            rest += b_
        return head

    with socket.create_connection((frontend.host, frontend.port),
                                  timeout=30) as s:
        for _ in range(2):  # second request proves the connection lived
            s.sendall(probe)
            head = read_response(s)
            assert head.startswith(b"HTTP/1.1 200"), head[:80]


def test_get_with_body_does_not_desync_keepalive(frontend):
    """A GET smuggling a body gets its bytes drained and the connection
    closed — leftover body bytes must never be parsed as the next
    request line (one request, one response, one accounting entry)."""
    before = _responses_total(frontend)
    body = b"x" * 10
    status, doc = raw_exchange(
        frontend,
        (f"GET /healthz HTTP/1.1\r\nHost: t\r\n"
         f"Content-Length: {len(body)}\r\n\r\n").encode("latin-1") + body)
    assert status == 200 and "queue" in doc
    assert _responses_total(frontend) == before + 1, \
        "body bytes were parsed as a second request"


def test_double_drain_is_noop(frontend):
    """A bodied request hitting both the route-level drain and the
    reject-level drain must not block: the first drain advances the
    consumed count, so the second is a no-op instead of a read-timeout
    stall on an empty socket (a cheap handler-pinning amplifier)."""
    body = b"x" * 100
    head = (f"GET /nowhere HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n")
    t0 = time.monotonic()
    status, doc = raw_exchange(frontend, head.encode("latin-1") + body)
    assert status == 404 and doc["code"] == "unknown_route", doc
    assert time.monotonic() - t0 < 2.0, "second drain blocked"


def test_keepalive_resets_body_accounting(frontend):
    """A keep-alive connection reuses the handler instance: request B's
    reject drain must size itself from B's own body, not A's leftover
    consumed count (regression: a negative budget skipped the drain and
    closed with unread bytes — the RST the drain exists to prevent)."""
    (ct, body), _ = good_multipart(rid=b"ka-1")
    req1 = stereo_request_bytes(ct, body)
    tail = b"y" * 100
    req2 = (f"DELETE /v1/stereo HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(tail)}\r\n\r\n").encode("latin-1") + tail
    with socket.create_connection((frontend.host, frontend.port),
                                  timeout=60) as s:
        s.sendall(req1 + req2)
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    raw = b"".join(chunks)
    assert raw.count(b"HTTP/1.1 ") == 2, raw[:200]
    first, second = raw.split(b"HTTP/1.1 ")[1:]
    assert first.startswith(b"200"), first[:80]
    assert second.startswith(b"405") and b"DELETE" in second, second[:200]


def test_unsupported_media_rejected_before_body_read(frontend):
    """The media type is in the HEADERS: an unsupported one answers 415
    without reading the declared body (previously it cost a full
    body_max-sized buffer before the same 415)."""
    huge = frontend.body_max  # declared, never sent
    head = (f"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: text/plain\r\n"
            f"Content-Length: {huge}\r\n\r\n")
    t0 = time.monotonic()
    status, doc = raw_exchange(frontend, head.encode("latin-1"),
                               half_close=True)  # EOF: drain is instant
    assert status == 415 and doc["code"] == "unsupported_media_type", doc
    assert time.monotonic() - t0 < frontend.body_deadline_s


def test_expect_100_header_stage_gates(service):
    """Expect: 100-continue runs EVERY header-stage gate before a 100
    invites the body: a quota-blown tenant gets its 429 while still
    waiting (non-consuming peek), wrong media types their 415."""
    cfg = HttpConfig(port=0, tenant_rate="0.001:1")  # burst 1, ~no refill
    with HttpFrontend(service, cfg) as fe:
        assert fe.quotas.admit("greedy")  # spend the burst
        head = (b"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
                b"Content-Type: multipart/form-data; boundary=x\r\n"
                b"Content-Length: 100\r\nExpect: 100-continue\r\n"
                b"X-Raft-Tenant: greedy\r\n\r\n")
        status, doc = raw_exchange(fe, head)
        assert status == 429 and doc["code"] == "quota_exceeded", doc
        # the Expect-gated 429 is still a quota rejection served to that
        # tenant: the tenant series must not under-count Expect clients
        # (curl sends Expect by default for multipart bodies)
        counts = {(lb["tenant"], lb["outcome"]): int(v) for lb, v in
                  fe.registry.series("raft_http_tenant_requests_total")}
        assert counts.get(("greedy", "quota_exceeded")) == 1, counts
        head = (b"POST /v1/stereo HTTP/1.1\r\nHost: t\r\n"
                b"Content-Type: text/plain\r\n"
                b"Content-Length: 100\r\nExpect: 100-continue\r\n\r\n")
        status, doc = raw_exchange(fe, head)
        assert status == 415 and doc["code"] == "unsupported_media_type"


def test_connection_cap_immediate_503(service):
    """Aggregate connection bound: every per-connection defense bounds
    ONE connection, so the listener caps concurrent handler threads —
    a connection over the cap gets an immediate minimal 503
    ``overloaded`` (written on the acceptor, no thread spawned), and a
    freed slot serves again."""
    with HttpFrontend(service, HttpConfig(port=0, max_connections=1)) as fe:
        # Hold the single slot: connect and send nothing — the handler
        # thread parks in the request-line read under its own timeout.
        hold = socket.create_connection((fe.host, fe.port), timeout=10)
        try:
            time.sleep(0.1)  # let the acceptor hand off the connection
            status, doc = raw_exchange(
                fe, b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            assert status == 503 and doc["code"] == "overloaded", doc
        finally:
            hold.close()
        # Slot released when the held connection's handler sees EOF.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            status, _ = raw_exchange(
                fe, b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200, "slot never freed after client close"


def test_decode_pool_shutdown_race_is_structured(service):
    """A handler that read its body but lost the race to stop()'s decode
    pool shutdown answers a structured 503 service_stopped, never a
    counted crash (regression: RuntimeError('cannot schedule new
    futures') -> 500 internal)."""
    with HttpFrontend(service, HttpConfig(port=0)) as fe:
        fe.decode_pool.shutdown(wait=False)
        before = crash_count(fe)
        (ct, body), _ = good_multipart(rid=b"pool-race")
        status, headers, doc = post(fe, ct, body)
        assert status == 503 and doc["code"] == "service_stopped", doc
        assert "Retry-After" in headers
        assert crash_count(fe) == before


# ---------------------------------------------------------------------------
# CLI decode offload (satellite 2)
# ---------------------------------------------------------------------------


def test_iter_decoded_pairs_order_and_bytes(tmp_path):
    """The batch driver's decode pool must be a pure pipelining change:
    same submission order, byte-identical decoded arrays vs the
    sequential path."""
    from raft_stereo_tpu_torch.serve_stereo import iter_decoded_pairs
    paths = []
    for i in range(7):
        left, right = png_pair(8, 12, seed=i)
        pl, pr = tmp_path / f"l{i}.png", tmp_path / f"r{i}.png"
        pl.write_bytes(wire.encode_image_png(left))
        pr.write_bytes(wire.encode_image_png(right))
        paths.append((str(pl), str(pr)))

    def decode_one(p):
        return read_image_rgb(p).astype(np.float32)[None]

    seq = [(f1, f2, (decode_one(f1), decode_one(f2))) for f1, f2 in paths]
    out = [(f1, f2, fut.result(timeout=30)) for f1, f2, fut in
           iter_decoded_pairs(paths, decode_one, workers=3)]
    assert [(a, b) for a, b, _ in out] == [(a, b) for a, b, _ in seq]
    for (_, _, (sl, sr)), (_, _, (ol, or_)) in zip(seq, out):
        assert sl.tobytes() == ol.tobytes()
        assert sr.tobytes() == or_.tobytes()


def test_iter_decoded_pairs_close_cancels_queued():
    """Closing the generator (the CLI's drain move) stops the pump and
    cancels every queued decode — the drain must not keep burning
    ~33 ms/sample on files whose requests will be stub-rejected."""
    from raft_stereo_tpu_torch.serve_stereo import iter_decoded_pairs
    calls = []

    def decode_one(p):
        calls.append(p)
        return p

    gen = iter_decoded_pairs([(f"l{i}", f"r{i}") for i in range(20)],
                             decode_one, workers=1)
    f1, _f2, fut = next(gen)
    fut.result(timeout=30)
    gen.close()
    time.sleep(0.2)  # any in-flight task would land within this
    # the one consumed pair decoded (2 calls); at most one more pair was
    # already mid-flight when close() cancelled the queue
    assert len(calls) <= 4, f"decode kept running after close: {calls}"


def test_cli_mode_validation_is_instant():
    """Missing -l/-r without --http_port dies before any model load or
    warmup compile (regression: the check ran after minutes of
    checkpoint read + jit)."""
    from raft_stereo_tpu_torch.serve_stereo import build_parser, serve
    args = build_parser().parse_args([])
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="batch mode needs"):
        serve(args)
    assert time.monotonic() - t0 < 1.0


def test_iter_decoded_pairs_bounded_lookahead():
    """The pool never decodes more than ``lookahead`` pairs ahead of the
    consumer — bounded memory regardless of glob size."""
    from raft_stereo_tpu_torch.serve_stereo import iter_decoded_pairs
    started = [0]
    lock = threading.Lock()

    def decode_one(_):
        with lock:
            started[0] += 1
        return np.zeros((1, 4, 4, 3), np.float32)

    pairs = [(f"l{i}", f"r{i}") for i in range(48)]
    gen = iter_decoded_pairs(pairs, decode_one, workers=2, lookahead=3)
    _, _, fut = next(gen)
    fut.result(timeout=30)
    time.sleep(0.3)  # ample time for an unbounded pool to run away
    # pump fills to 3 pairs, the one consumed yield refills once: at most
    # 4 pairs = 8 decodes may have STARTED while the consumer stalls —
    # not 96 (the unbounded failure this pins against).
    assert started[0] <= 8, started[0]
    n = 1
    for _, _, fut in gen:
        fut.result(timeout=30)
        n += 1
    assert n == 48 and started[0] == 96


@pytest.mark.parametrize("mesh", [(), ("--mesh_data", "2", "--max_batch", "2")],
                         ids=["one_device", "mesh_data_2"])
def test_cli_ready_handshake_stdout_and_fd(tmp_path, mesh):
    """The live CLI's readiness handshake.

    ``--http_port 0`` must print exactly one machine-parseable
    ``RAFT_HTTP_PORT=<n>`` line to stdout AFTER the listening event
    (i.e. after warmup — a supervisor that reads it can route
    immediately), and ``--ready_fd`` must deliver the same line over an
    inherited pipe followed by EOF.  The advertised port must actually
    serve /healthz carrying the top-level fingerprint_id/uptime_s
    fields the fleet router consumes.  One real subprocess (~15 s tiny
    CPU model) — the price of pinning the contract on the production
    entry point rather than a refactored fragment of it.  With
    ``--mesh_data 2`` (the CPU listed twice) the server also answers one
    request over the wire and /healthz carries the mesh block.
    """
    import os
    import signal
    import subprocess
    import sys

    r_fd, w_fd = os.pipe()
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_stereo_tpu_torch.serve_stereo", "--device", "cpu",
         "--http_port", "0", "--no_canary", "--ready_fd", str(w_fd),
         "--valid_iters", "2", "--segments", "2",
         "--n_gru_layers", "1", "--hidden_dims", "32", "32", "32",
         "--corr_levels", "2", "--corr_radius", "2",
         "--corr_implementation", "reg", *mesh],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        pass_fds=(w_fd,), cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    os.close(w_fd)
    try:
        timer = threading.Timer(240.0, proc.kill)
        timer.start()
        seen_listening = False
        port = None
        try:
            for line in proc.stdout:
                line = line.strip()
                if line.startswith("{"):
                    doc = json.loads(line)
                    if doc.get("event") == "listening":
                        seen_listening = True
                    continue
                if line.startswith("RAFT_HTTP_PORT="):
                    assert seen_listening, (
                        "handshake printed before the listening event")
                    port = int(line.split("=", 1)[1])
                    break
        finally:
            timer.cancel()
        assert port is not None, "no RAFT_HTTP_PORT handshake on stdout"
        # --ready_fd: same line over the inherited pipe, then EOF.
        with os.fdopen(r_fd, "r") as ready_pipe:
            r_fd = None
            assert ready_pipe.read() == f"RAFT_HTTP_PORT={port}\n"
        # The advertised port serves, and /healthz carries the fleet
        # router's generation-identity fields at the top level.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            assert resp.status == 200
            health = json.loads(resp.read())
        assert isinstance(health["fingerprint_id"], str)
        assert len(health["fingerprint_id"]) == 12
        assert health["uptime_s"] >= 0
        if mesh:
            (ct, body), (left, _) = good_multipart()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/stereo", data=body, method="POST",
                headers={"Content-Type": ct})
            with urllib.request.urlopen(req, timeout=120) as resp:
                doc = wire.decode_response(resp.read())
            assert doc["status"] == "ok" and doc["disparity"].shape == left.shape[:2]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
                health = json.loads(resp.read())
            st = health["session"]["mesh"]
            assert st["enabled"] and st["n_data"] == st["base_n_data"] == 2
            assert [d["device"] for d in st["devices"]] == ["cpu", "cpu"]
            assert health["session"]["batch_buckets"] == [2]
            assert health["capacity"]["chips"]["n_data"] == 2
            assert any(c.endswith("/mesh2") for c in health["session"]["programs"]["cached"])
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
        assert proc.returncode == 0
    finally:
        if r_fd is not None:
            os.close(r_fd)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# Both packages' copies side by side
# ---------------------------------------------------------------------------


def test_wire_codec_bytes_equal_across_packages():
    """encode_response, build_multipart / parse_multipart and the PNG
    encoder give the JAX copy's bytes."""
    disp = np.linspace(-3, 7, 24, dtype=np.float32).reshape(4, 6)
    for resp in ({"status": "ok", "id": "q-7", "quality": "reduced_iters:16", "iters": 16,
                  "retries": 2, "elapsed_ms": 12.5, "deadline_missed": False,
                  "disparity": disp},
                 {"status": "rejected", "code": "queue_full", "message": "full", "id": 3},
                 {"status": "error", "code": "kernel_failed", "message": "x"}):
        assert wire.encode_response(resp) == jax_wire.encode_response(resp)
    left, right = png_pair(12, 20)
    assert wire.encode_image_png(left) == jax_wire.encode_image_png(left)
    fields = {"left": wire.encode_image_png(left), "right": wire.encode_image_png(right),
              "id": b"p-1", "deadline_ms": b"250"}
    ct, body = wire.build_multipart(fields)
    assert (ct, body) == jax_wire.build_multipart(fields)
    boundary = wire.parse_content_type(ct)[1]["boundary"]
    assert wire.parse_multipart(body, boundary) == jax_wire.parse_multipart(body, boundary)
    ours = wire.parse_stereo_request(ct, {}, body)
    theirs = jax_wire.parse_stereo_request(ct, {}, body)
    assert ours == theirs


@pytest.mark.parametrize("mangle", [
    lambda b: b[:len(b) // 2], lambda b: b[:-6], lambda b: b"junk" + b,
    lambda b: b.replace(b"--raftwire\r\n", b"--raftwire..", 1)])
def test_wire_rejections_equal_across_packages(mangle):
    ct, body = wire.build_multipart({"left": b"LL", "right": b"RR"})
    codes = []
    for mod in (wire, jax_wire):
        with pytest.raises(mod.WireRejected) as exc:
            mod.parse_stereo_request(ct, {}, mangle(body))
        codes.append((exc.value.code, exc.value.http_status))
    assert codes[0] == codes[1] == ("bad_multipart", 400)


@pytest.mark.parametrize("code", [None, "queue_full", "service_draining", "quota_exceeded",
                                  "deadline_exceeded", "deadline_exceeded_in_queue",
                                  "invalid_input:too_large", "nonfinite_output",
                                  "kernel_failed", "upload_failed", "not_running"])
def test_status_table_equal_across_packages(code):
    for status in (("ok",) if code is None else ("rejected", "error")):
        resp = {"status": status} if code is None else {"status": status, "code": code}
        assert wire.http_status_for(resp) == jax_wire.http_status_for(resp)
        assert wire.retry_after_for(resp) == jax_wire.retry_after_for(resp)


def test_bomb_png_raises_image_too_large_in_both_packages(tmp_path, monkeypatch):
    """A crafted PNG over RAFT_DECODE_MAX_PIXELS: ImageTooLarge from both
    packages' read_image_rgb and from the port's demo reader (which reads
    through the guard)."""
    monkeypatch.setenv("RAFT_DECODE_MAX_PIXELS", str(640 * 480))
    p = tmp_path / "bomb.png"
    p.write_bytes(bomb_png(1000, 1000))
    for reader in (read_image_rgb, jax_frame_utils.read_image_rgb, port_demo.read_image_rgb):
        with pytest.raises(ValueError) as exc:
            reader(p)
        assert type(exc.value).__name__ == "ImageTooLarge"
        assert exc.value.code == "image_too_large" and "1000x1000" in str(exc.value)
    ok = tmp_path / "ok.png"
    left, _ = png_pair(24, 32)
    ok.write_bytes(wire.encode_image_png(left))
    assert port_demo.read_image_rgb(ok).tobytes() == \
        jax_frame_utils.read_image_rgb(ok).tobytes() == left.tobytes()


def test_cli_unported_flags_raise_before_the_model_loads():
    """Every flag is ported now (``--mesh_data 2``: the mesh case of
    ``test_cli_ready_handshake_stdout_and_fd``); a mesh below one device
    ends the run at once, before the model loads, naming the flag."""
    from raft_stereo_tpu_torch.serve_stereo import build_parser, serve
    for argv, item in ((["--mesh_data", "0"], "--mesh_data must be >= 1"),):
        args = build_parser().parse_args(["--http_port", "0", *argv])
        t0 = time.monotonic()
        with pytest.raises(SystemExit, match=item):
            serve(args)
        assert time.monotonic() - t0 < 1.0


def test_cli_and_demo_serve_the_ports_own_bundle(tmp_path, capsys):
    """A ``.pt`` bundle written by ``engine/checkpoint.save_checkpoint``
    from a seeded tiny model (seed 7; the CLI's own random weights are
    seed 0) serves through the CLI in batch mode and runs in the demo:
    both disparities equal the in-process model's, loaded from the same
    bundle, on the same pair (fp32, bit for bit)."""
    from raft_stereo_tpu_torch.engine import checkpoint as ckpt
    from raft_stereo_tpu_torch.models import raft_stereo_forward
    from raft_stereo_tpu_torch.ops.padder import InputPadder
    from raft_stereo_tpu_torch.serve_stereo import build_parser, serve
    seeded = init_raft_stereo(RAFTStereoConfig(**TINY), seed=7, device="cpu")
    bundle = ckpt.save_checkpoint(str(tmp_path / "tiny.pt"), seeded)
    left, right = png_pair(seed=11)
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "im0.png").write_bytes(wire.encode_image_png(left))
    (tmp_path / "s" / "im1.png").write_bytes(wire.encode_image_png(right))
    arch = ["--n_gru_layers", "1", "--hidden_dims", "32", "32", "32", "--corr_levels", "2",
            "--corr_radius", "2", "--corr_implementation", "reg", "--valid_iters", "2"]
    pair = ["-l", str(tmp_path / "s" / "im0.png"), "-r", str(tmp_path / "s" / "im1.png")]
    args = build_parser().parse_args([
        "--device", "cpu", "--no_canary", "--watchdog_ms", "0", "--max_queue", "1",
        "--segments", "2", "--cache_bytes", "0", "--restore_ckpt", bundle, "--output_directory",
        str(tmp_path / "served"), *arch, *pair])
    assert serve(args) == 0
    capsys.readouterr()
    served = np.load(next((tmp_path / "served").glob("*_disp.npy")))
    port_demo.main(["--restore_ckpt", bundle, *pair, "--output_directory",
                    str(tmp_path / "demo"), "--save_numpy", "--device", "cpu", *arch])
    demo_disp = -np.load(tmp_path / "demo" / "s.npy")

    model = init_raft_stereo(RAFTStereoConfig(**TINY), seed=0, device="cpu")
    ckpt.load_params(bundle, model)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), seeded.state_dict().values()))
    images = [torch.from_numpy(x[None].astype(np.float32)) for x in (left, right)]
    padder = InputPadder(images[0].shape, divis_by=32)
    _, flow_up = raft_stereo_forward(model, *padder.pad(*images), iters=2)
    ref = -padder.unpad(flow_up)[0, ..., 0].numpy()
    assert served.shape == demo_disp.shape == ref.shape == (H, W)
    np.testing.assert_array_equal(served, ref)
    np.testing.assert_array_equal(demo_disp, ref)


def test_cli_serves_with_the_stream_and_cache_flags(tmp_path, monkeypatch, capsys):
    """The stream and cache flags serve (batch mode, in process): a pair
    glob whose second pair repeats the first comes back cache:exact and
    bit for bit, and the final /healthz document carries the configured
    stream table and cache, its disk spill from RAFT_CACHE_DIR."""
    from raft_stereo_tpu_torch.serve_stereo import build_parser, serve
    spill = tmp_path / "spill"
    monkeypatch.setenv("RAFT_CACHE_DIR", str(spill))
    left, right = png_pair(seed=3)
    for i in (0, 1):
        d = tmp_path / f"s{i}"
        d.mkdir()
        (d / "im0.png").write_bytes(wire.encode_image_png(left))
        (d / "im1.png").write_bytes(wire.encode_image_png(right))
    args = build_parser().parse_args([
        "--device", "cpu", "--no_canary", "--valid_iters", "2", "--segments", "2",
        "--n_gru_layers", "1", "--hidden_dims", "32", "32", "32", "--corr_levels", "2",
        "--corr_radius", "2", "--corr_implementation", "reg", "--max_queue", "1",
        "--watchdog_ms", "0", "--stream_sessions", "4", "--stream_ttl_ms", "5000",
        "--converge_tol", "0.5", "--cache_bytes", str(1 << 20), "--cache_near_tol", "2",
        "-l", str(tmp_path / "s*" / "im0.png"), "-r", str(tmp_path / "s*" / "im1.png")])
    assert serve(args) == 0
    lines = capsys.readouterr().out.splitlines()
    # One JSON line a response, then the final /healthz document, indented.
    start = len(lines) - 1 - lines[::-1].index("{")
    served = [json.loads(line) for line in lines[:start] if line.startswith('{"')]
    assert [d["quality"] for d in served if d.get("status") == "ok"] == ["full", "cache:exact"]
    health = json.loads("\n".join(lines[start:]))
    assert health["stream"]["max_sessions"] == 4
    assert health["stream"]["ttl_ms"] == 5000.0
    assert health["stream"]["converge_tol"] == 0.5
    assert health["cache"]["max_bytes"] == 1 << 20
    assert health["cache"]["near_tol"] == 2.0 and health["cache"]["hits"] == 1
    assert health["cache"]["disk"]["dir"] == str(spill)


def test_session_header_warm_starts_over_wire(service):
    """X-Raft-Session makes consecutive POSTs one stream: the second frame
    warm-starts from the first, and X-Raft-Converge-Tol exits it at the
    first segment boundary with the honest converged:k label."""
    with HttpFrontend(service, HttpConfig(port=0)) as fe:
        (ct, body), _ = good_multipart(seed=8)
        before = int(service.registry.value("raft_stream_warm_joins_total"))
        status, _, first = post(fe, ct, body, headers={"X-Raft-Session": "rig-1"})
        assert status == 200 and first["quality"] == "full"
        status, _, second = post(fe, ct, body, headers={"X-Raft-Session": "rig-1",
                                                        "X-Raft-Converge-Tol": "1e9"})
        assert status == 200 and second["quality"] == "converged:2"
        assert second["iters"] == 2
        assert int(service.registry.value("raft_stream_warm_joins_total")) == before + 1
        assert service.status()["stream"]["sessions"] >= 1
