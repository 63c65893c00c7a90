"""Minimal HTTP/1.1 request/response framing for the profiler service.

Pure functions over byte buffers — parsing never does I/O, so the
service's selector event loop stays non-blocking by construction (the
loop-blocking lint walks through here).  Deliberately tiny rather than
general: the service is GET-only, bodies are ignored, responses close
the connection (except ``/api/stream``, which switches to chunked
transfer and stays open until the client hangs up).
"""
from __future__ import annotations

import dataclasses
import json
from urllib.parse import parse_qsl, unquote, urlsplit

#: Upper bound on one request head; a client that sends more without a
#: blank line is broken or hostile and gets a 400.
MAX_REQUEST_BYTES = 64 * 1024

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class HttpError(Exception):
    """Malformed request; carries the status the server should answer."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = int(status)
        self.message = message


@dataclasses.dataclass
class Request:
    """One parsed request head (GET has no body we care about)."""
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]    # keys lower-cased

    def query_int(self, key: str, default: int | None = None,
                  lo: int | None = None,
                  hi: int | None = None) -> int | None:
        raw = self.query.get(key)
        if raw is None or raw == "":
            return default
        try:
            v = int(raw)
        except ValueError:
            raise HttpError(400, f"query parameter {key!r} must be an "
                            f"integer (got {raw!r})") from None
        if lo is not None:
            v = max(v, lo)
        if hi is not None:
            v = min(v, hi)
        return v

    def query_float(self, key: str,
                    default: float | None = None) -> float | None:
        raw = self.query.get(key)
        if raw is None or raw == "":
            return default
        try:
            return float(raw)
        except ValueError:
            raise HttpError(400, f"query parameter {key!r} must be a "
                            f"number (got {raw!r})") from None


def parse_request(buf: bytes) -> tuple[Request, int] | None:
    """Parse one request head out of ``buf``.

    Returns ``(request, consumed_bytes)`` once the blank line has
    arrived, ``None`` while the head is still incomplete, and raises
    :class:`HttpError` on garbage (malformed request line, non-HTTP/1.x,
    or a head exceeding :data:`MAX_REQUEST_BYTES`).
    """
    end = buf.find(b"\r\n\r\n")
    if end < 0:
        if len(buf) > MAX_REQUEST_BYTES:
            raise HttpError(400, "request head too large")
        return None
    try:
        head = buf[:end].decode("latin-1")
    except UnicodeDecodeError:      # pragma: no cover - latin-1 total
        raise HttpError(400, "undecodable request head") from None
    lines = head.split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"malformed request line {lines[0]!r}")
    method, target, _version = parts
    sp = urlsplit(target)
    query = dict(parse_qsl(sp.query, keep_blank_values=True))
    headers: dict[str, str] = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    path = unquote(sp.path) or "/"
    return Request(method.upper(), path, query, headers), end + 4


def response(status: int, body: bytes | str = b"",
             content_type: str = "application/json; charset=utf-8",
             extra_headers: tuple[str, ...] = ()) -> bytes:
    """Frame one complete ``Connection: close`` response."""
    if isinstance(body, str):
        body = body.encode("utf-8")
    reason = _REASONS.get(status, "Unknown")
    head = [
        f"HTTP/1.1 {status} {reason}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
        "Cache-Control: no-store",
        "Connection: close",
        *extra_headers,
    ]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def json_response(status: int, doc) -> bytes:
    return response(status, json.dumps(doc, indent=2))


def error_response(status: int, message: str) -> bytes:
    return json_response(status, {"status": status, "error": message})


def stream_head(content_type: str = "application/x-ndjson") -> bytes:
    """Response head opening a chunked (unbounded) body — the
    ``/api/stream`` framing; follow with :func:`chunk` payloads."""
    head = [
        "HTTP/1.1 200 OK",
        f"Content-Type: {content_type}",
        "Transfer-Encoding: chunked",
        "Cache-Control: no-store",
        "Connection: close",
    ]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")


def chunk(data: bytes | str) -> bytes:
    """One chunked-transfer frame (empty input frames the terminator)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return f"{len(data):x}\r\n".encode("latin-1") + data + b"\r\n"
