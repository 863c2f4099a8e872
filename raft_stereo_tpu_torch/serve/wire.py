"""Wire-level request/response codec for the HTTP ingress (graftwire).

The port's copy of the JAX package's ``serve/wire.py``: the same parsers,
codes, statuses and bytes (held to the JAX copy in
tests/test_torch_http.py).

The frontend (serve/http.py) owns sockets and threads; THIS module owns
bytes: parsing a hostile request body into a stereo pair, decoding image
bytes behind the decompression-bomb guard, and serializing the
response contract onto the wire unchanged. Everything here is pure
bytes-in/values-out — no sockets, no service state — so the whole codec
is unit-testable without a server and the hostile-input battery
(tests/test_http.py) can pin one stable code per malformation.

Two request encodings for ``POST /v1/stereo``:

- ``multipart/form-data`` with file parts ``left`` and ``right`` (PNG or
  JPEG bytes) plus optional text parts ``id`` / ``deadline_ms`` — the
  curl-friendly form. The parser is hand-rolled and STRICT (exact
  CRLF-delimited boundaries, closing terminator required): a truncated
  or boundary-less body is ``bad_multipart``, never a silently-partial
  parse (the stdlib ``email`` parser is lenient by design, which is the
  wrong property for hostile input);
- ``application/x-raft-stereo``: two raw image parts concatenated, with
  ``X-Raft-Left-Len`` / ``X-Raft-Right-Len`` declaring the split — the
  zero-framing-overhead form a programmatic client uses.

The response is JSON carrying EVERY key of the in-process response dict
(quality labels, structured errors, ``retries: k`` — test-pinned), with
the disparity array encoded as ``{dtype, shape, b64}`` (raw little-endian
float32 bytes, base64) so a client round-trips it bit-exactly
(:func:`decode_response`).

Status mapping (DESIGN.md r14): honest HTTP codes derived from the
structured response — backpressure and drain are 503 (with Retry-After),
quota is 429, expired deadlines are 504, admission rejects are 400, and
internal/serving errors are 500. Wire-level malformations carry their own
status on :class:`WireRejected`.
"""

from __future__ import annotations

import base64
import io
import json
import math
from typing import Dict, Optional, Tuple

import numpy as np

#: Structured rejection codes -> HTTP status, for codes the service (not
#: the wire layer) produces. Everything rejected and unlisted is a 400
#: (admission control: invalid_input:*), everything with status "error"
#: is a 500 — the ingress never invents a success code.
REJECT_STATUS: Dict[str, int] = {
    "queue_full": 503,
    "service_draining": 503,
    "service_stopped": 503,
    "not_running": 503,
    "quota_exceeded": 429,
    "deadline_exceeded": 504,
    "deadline_exceeded_in_queue": 504,
}

#: Codes whose response carries a Retry-After header (seconds): the
#: client is told to come back, not to give up — 503s are transient by
#: contract (bounded queue, drain in progress), 429 is a refill wait.
RETRY_AFTER_S: Dict[str, int] = {
    "queue_full": 1,
    "service_draining": 5,
    "service_stopped": 5,
    "not_running": 5,
    "quota_exceeded": 1,
}


class WireRejected(ValueError):
    """A request failed at the wire layer (framing, codec, decode) —
    before it could become a service submission. ``code`` is the stable
    machine-readable rejection class; ``http_status`` the honest HTTP
    mapping."""

    def __init__(self, code: str, message: str, http_status: int = 400):
        self.code = code
        self.http_status = http_status
        super().__init__(message)


def http_status_for(resp: Dict) -> int:
    """HTTP status for one structured service response."""
    status = resp.get("status")
    if status == "ok":
        return 200
    if status == "error":
        return 500
    return REJECT_STATUS.get(str(resp.get("code", "")), 400)


def retry_after_for(resp: Dict) -> Optional[int]:
    return RETRY_AFTER_S.get(str(resp.get("code", "")))


# ---------------------------------------------------------------------------
# Request parsing
# ---------------------------------------------------------------------------

#: The two request encodings POST /v1/stereo accepts. The frontend
#: checks the media type against this BEFORE reading the body (an
#: unsupported type must not cost a body_max-sized buffer);
#: parse_stereo_request re-checks so the codec stays correct standalone.
SUPPORTED_MEDIA = ("multipart/form-data", "application/x-raft-stereo")


def parse_content_type(raw: Optional[str]) -> Tuple[str, Dict[str, str]]:
    """``type/subtype; k=v; ...`` -> (lowercased media type, params).
    Tolerant of whitespace and quoted parameter values; never raises —
    an unparseable header is simply an unknown media type."""
    if not raw:
        return "", {}
    parts = raw.split(";")
    media = parts[0].strip().lower()
    params: Dict[str, str] = {}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        k = k.strip().lower()
        v = v.strip()
        if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
            v = v[1:-1]
        if k:
            params[k] = v
    return media, params


def _part_name(head: bytes) -> Optional[str]:
    """``name="..."`` from a part's Content-Disposition header lines."""
    for line in head.split(b"\r\n"):
        k, _, v = line.partition(b":")
        if k.strip().lower() != b"content-disposition":
            continue
        _, params = parse_content_type("x/x;" + v.decode("latin-1"))
        return params.get("name")
    return None


def parse_multipart(body: bytes, boundary: str) -> Dict[str, bytes]:
    """Strict ``multipart/form-data`` split: parts keyed by their
    Content-Disposition ``name``.

    Strictness IS the defense: every violation — missing boundary
    parameter, body not opening with the dash-boundary, a part without
    the blank-line header separator, a missing closing ``--`` terminator
    (the truncated-upload case) — is one ``bad_multipart`` rejection.
    The body is already fully read and bounded by the frontend's
    content-length cap, so this parser never sees unbounded input.
    """
    if not boundary:
        raise WireRejected("bad_multipart",
                           "multipart content-type carries no boundary")
    delim = b"--" + boundary.encode("latin-1")
    if not body.startswith(delim):
        raise WireRejected(
            "bad_multipart",
            "body does not start with the declared boundary")
    parts: Dict[str, bytes] = {}
    rest = body[len(delim):]
    while True:
        if rest.startswith(b"--"):
            return parts  # closing terminator reached: parse complete
        if not rest.startswith(b"\r\n"):
            raise WireRejected("bad_multipart",
                               "malformed boundary delimiter (no CRLF)")
        rest = rest[2:]
        head, sep, tail = rest.partition(b"\r\n\r\n")
        if not sep:
            raise WireRejected(
                "bad_multipart",
                "part headers never terminate (truncated upload?)")
        idx = tail.find(b"\r\n" + delim)
        if idx < 0:
            raise WireRejected(
                "bad_multipart",
                "part content never reaches a closing boundary "
                "(truncated upload)")
        name = _part_name(head)
        if name:
            parts[name] = tail[:idx]
        rest = tail[idx + 2 + len(delim):]


def parse_stereo_request(content_type: Optional[str], headers,
                         body: bytes) -> Dict:
    """One POST /v1/stereo body -> ``{left, right, id, deadline_ms}``
    with ``left``/``right`` still ENCODED image bytes (the decode runs in
    the frontend's offload pool, not here, and not on the acceptor).

    ``headers`` is any mapping with ``.get`` (the stdlib message object);
    ``X-Raft-Id`` / ``X-Raft-Deadline-Ms`` override body-carried fields
    so the raw-pair encoding needs no side-channel parts.
    """
    if not body:
        raise WireRejected("empty_body", "request body is empty")
    media, params = parse_content_type(content_type)
    fields: Dict[str, Optional[str]] = {"id": None, "deadline_ms": None,
                                        "converge_tol": None}
    if media == "multipart/form-data":
        parts = parse_multipart(body, params.get("boundary", ""))
        for k in fields:
            if k in parts:
                fields[k] = parts[k].decode("utf-8", "replace")
        left = parts.get("left")
        right = parts.get("right")
        if left is None or right is None:
            missing = [k for k in ("left", "right") if k not in parts]
            raise WireRejected(
                "missing_part",
                f"multipart body lacks required part(s): {missing}")
    elif media == "application/x-raft-stereo":
        lens = []
        for h in ("X-Raft-Left-Len", "X-Raft-Right-Len"):
            raw = headers.get(h)
            if raw is None:
                raise WireRejected(
                    "missing_part",
                    f"raw-pair encoding requires the {h} header")
            try:
                n = int(raw)
            except ValueError:
                raise WireRejected(
                    "bad_part_lengths",
                    f"{h} must be an integer, got {raw!r}") from None
            if n < 0:
                raise WireRejected("bad_part_lengths",
                                   f"{h} must be non-negative, got {n}")
            lens.append(n)
        if lens[0] + lens[1] != len(body):
            raise WireRejected(
                "bad_part_lengths",
                f"declared part lengths {lens[0]}+{lens[1]} != body "
                f"length {len(body)} (truncated upload?)")
        left, right = body[:lens[0]], body[lens[0]:]
    else:
        raise WireRejected(
            "unsupported_media_type",
            f"content-type {media or '(none)'!r} is not one of "
            f"multipart/form-data, application/x-raft-stereo",
            http_status=415)
    for h, k in (("X-Raft-Id", "id"), ("X-Raft-Deadline-Ms", "deadline_ms"),
                 ("X-Raft-Converge-Tol", "converge_tol")):
        v = headers.get(h)
        if v is not None:
            fields[k] = v
    deadline_ms: Optional[float] = None
    if fields["deadline_ms"] is not None:
        try:
            deadline_ms = float(fields["deadline_ms"])
        except ValueError:
            raise WireRejected(
                "bad_deadline",
                f"deadline_ms must be a number, "
                f"got {fields['deadline_ms']!r}") from None
        if not math.isfinite(deadline_ms):
            # float() accepts "nan"/"inf"; a NaN deadline makes every
            # downstream now-vs-deadline comparison False, silently
            # disabling the deadline machinery for that request.
            raise WireRejected(
                "bad_deadline",
                f"deadline_ms must be finite, "
                f"got {fields['deadline_ms']!r}")
    converge_tol: Optional[float] = None
    if fields["converge_tol"] is not None:
        # Streaming convergence tolerance (graftstream): same hostile-
        # input stance as the deadline — a NaN would make the norm
        # comparison silently False, a negative is meaningless.
        try:
            converge_tol = float(fields["converge_tol"])
        except ValueError:
            raise WireRejected(
                "bad_converge_tol",
                f"converge_tol must be a number, "
                f"got {fields['converge_tol']!r}") from None
        if not math.isfinite(converge_tol) or converge_tol < 0:
            raise WireRejected(
                "bad_converge_tol",
                f"converge_tol must be finite and >= 0, "
                f"got {fields['converge_tol']!r}")
    return {"left": left, "right": right, "id": fields["id"],
            "deadline_ms": deadline_ms, "converge_tol": converge_tol}


# ---------------------------------------------------------------------------
# Image decode (runs in the frontend's offload pool)
# ---------------------------------------------------------------------------

def decode_image_rgb(data: bytes, name: str,
                     max_pixels: Optional[int] = None) -> np.ndarray:
    """Decode PNG/JPEG bytes -> (H, W, 3) uint8, behind the
    decompression-bomb guard: PIL's ``open`` parses only the header, the
    declared pixel count is checked against the decode cap, and only
    then does the array conversion run the actual decoder.
    ``image_too_large`` maps to 413; any other decode failure is one
    ``bad_image`` rejection (a garbage payload must cost a parse
    attempt, never a crash or an allocation).

    PIL imports lazily (function scope): ``import
    raft_stereo_tpu_torch.serve`` must not hard-depend on the image stack
    a wire-less embedder never uses.
    """
    from PIL import Image

    from raft_stereo_tpu_torch.data.frame_utils import ImageTooLarge, guard_decode_size
    try:
        img = Image.open(io.BytesIO(data))
        guard_decode_size(img.size, source=name, max_pixels=max_pixels)
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    except ImageTooLarge as e:
        raise WireRejected("image_too_large", str(e), http_status=413) \
            from e
    except Image.DecompressionBombError as e:
        # PIL's own tripwire fires inside ``open`` for declarations ~5x
        # above our default cap — same defense, same stable code.
        raise WireRejected("image_too_large", f"{name}: {e}",
                           http_status=413) from e
    except WireRejected:
        raise
    except Exception as e:  # noqa: BLE001 — hostile-bytes boundary
        raise WireRejected(
            "bad_image",
            f"{name}: cannot decode image bytes ({type(e).__name__}: "
            f"{e})") from e
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise WireRejected("bad_image",
                           f"{name}: decoded to shape {arr.shape}, "
                           f"expected (H, W, 3)")
    return arr


def decode_canonical(data: bytes, name: str,
                     max_pixels: Optional[int] = None) -> np.ndarray:
    """One image -> the canonical float32 ``(1, H, W, 3)`` array (the
    exact form ``validate_pair`` returns, so admission skips nothing).
    The frontend submits the two images of a request as SEPARATE pool
    tasks — decode caps the host path, and one combined
    task would serialize the pair even with an idle decode worker."""
    return decode_image_rgb(data, name, max_pixels).astype(
        np.float32)[None]


def decode_pair(left_bytes: bytes, right_bytes: bytes,
                max_pixels: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Both images of a request, sequentially — the in-thread
    convenience form (tests, single-worker callers)."""
    return (decode_canonical(left_bytes, "left", max_pixels),
            decode_canonical(right_bytes, "right", max_pixels))


# ---------------------------------------------------------------------------
# Response encoding
# ---------------------------------------------------------------------------

def encode_response(resp: Dict) -> bytes:
    """Serialize one structured service response to the wire.

    Every key passes through unchanged (the response contract —
    quality labels, structured errors, ``retries: k`` — is test-pinned
    to survive serialization); the disparity ndarray becomes
    ``{dtype, shape, b64}`` with raw little-endian bytes so
    :func:`decode_response` restores it bit-exactly."""
    doc = dict(resp)
    disp = doc.pop("disparity", None)
    if disp is not None:
        arr = np.ascontiguousarray(disp, dtype="<f4")
        doc["disparity"] = {
            "dtype": "float32",
            "shape": list(arr.shape),
            "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
        }
    return json.dumps(doc, default=str).encode("utf-8")


def decode_response(payload: bytes) -> Dict:
    """Client-side inverse of :func:`encode_response` (tests, bench, the
    chaos storm): the disparity comes back as the exact float32 array
    that was served."""
    doc = json.loads(payload.decode("utf-8"))
    disp = doc.get("disparity")
    if isinstance(disp, dict):
        doc["disparity"] = np.frombuffer(
            base64.b64decode(disp["b64"]), dtype="<f4").reshape(
                disp["shape"]).copy()
    return doc


# ---------------------------------------------------------------------------
# Client-side builders (tests / bench / chaos storm)
# ---------------------------------------------------------------------------

def encode_image_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> PNG bytes (lossless: the server decodes back
    the identical array, which is what makes the loopback parity
    acceptance byte-exact)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def build_multipart(parts: Dict[str, bytes],
                    boundary: str = "raftwire") -> Tuple[str, bytes]:
    """(content_type, body) for a multipart/form-data request — the
    canonical client encoding the parser above accepts."""
    chunks = []
    for name, data in parts.items():
        chunks.append(
            b"--" + boundary.encode() + b"\r\n"
            b'Content-Disposition: form-data; name="' + name.encode()
            + b'"\r\n\r\n' + data + b"\r\n")
    body = b"".join(chunks) + b"--" + boundary.encode() + b"--\r\n"
    return f"multipart/form-data; boundary={boundary}", body
