"""Pure-Python port of the native cluster route scanner (a copy of
``sitewhere_tpu/native/route_fallback.py``).

The cluster router's correctness invariant is that EVERY implementation
routes a given payload to the SAME rank — a divergence registers one
device under two identities on two ranks. The authoritative semantics
are the native scanner's (native/src/swtpu.cpp:route_json_impl), because
that is also how the batch DECODER reads envelopes: lenient top-level
scan, deviceToken preferred over hardwareId, last duplicate key wins,
empty/non-string token values fall through, escapes (including
surrogate pairs) decode to the same bytes the interner sees, and token
bytes hash with FNV-1a.

This module is that scanner, line for line, in Python — the route of a
batch that is not a ``list[bytes]`` (``native/binding.route_payloads``
returns None for it), so speed is irrelevant but byte-exact agreement is
mandatory (tests/test_torch_sources.py drives both over the same
payloads).
"""

from __future__ import annotations

import re
import struct

_WS = b" \t\n\r"
_HEX = {c: i for i, c in enumerate(b"0123456789abcdef")}
for _i, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _i

# std::from_chars(general) number shape: sign? (digits[.digits?] | .digits)
# (e sign? digits)? | inf | infinity | nan[(seq)]  (case-insensitive)
_NUM_RE = re.compile(
    rb"-?(?:infinity|inf|nan(?:\([0-9a-z_]*\))?"
    rb"|(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-][0-9]+|[eE][0-9]+)?)",
    re.IGNORECASE)

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def fnv1a_bytes(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class _Scan:
    __slots__ = ("buf", "p", "end", "ok")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.p = 0
        self.end = len(buf)
        self.ok = True


def _skip_ws(sc: _Scan) -> None:
    buf, p, end = sc.buf, sc.p, sc.end
    while p < end and buf[p] in _WS:
        p += 1
    sc.p = p


def _expect(sc: _Scan, ch: int) -> bool:
    _skip_ws(sc)
    if sc.p < sc.end and sc.buf[sc.p] == ch:
        sc.p += 1
        return True
    sc.ok = False
    return False


def _parse_string(sc: _Scan, cap: int) -> "bytearray | None":
    """Unescaping copy — the C parse_string byte for byte, including its
    cap-truncation guards and surrogate-pair handling."""
    _skip_ws(sc)
    buf = sc.buf
    if sc.p >= sc.end or buf[sc.p] != 0x22:
        sc.ok = False
        return None
    sc.p += 1
    out = bytearray()
    n = 0

    def put(c: int) -> None:
        nonlocal n
        if n < cap:
            out.append(c)
            n += 1

    while sc.p < sc.end:
        c = buf[sc.p]
        sc.p += 1
        if c == 0x22:
            return out
        if c == 0x5C:  # backslash
            if sc.p >= sc.end:
                break
            e = buf[sc.p]
            sc.p += 1
            if e == ord("n"):
                c = 0x0A
            elif e == ord("t"):
                c = 0x09
            elif e == ord("r"):
                c = 0x0D
            elif e == ord("b"):
                c = 0x08
            elif e == ord("f"):
                c = 0x0C
            elif e == ord("u"):
                if sc.end - sc.p < 4:
                    sc.ok = False
                    return None
                code = 0
                for _ in range(4):
                    h = _HEX.get(buf[sc.p])
                    sc.p += 1
                    if h is None:
                        sc.ok = False
                        return None
                    code = (code << 4) | h
                if 0xD800 <= code < 0xDC00:
                    lo = -1
                    if (sc.end - sc.p >= 6 and buf[sc.p] == 0x5C
                            and buf[sc.p + 1] == ord("u")):
                        lo = 0
                        for i in range(2, 6):
                            h = _HEX.get(buf[sc.p + i])
                            if h is None:
                                lo = -1
                                break
                            lo = (lo << 4) | h
                    if lo is not None and 0xDC00 <= lo < 0xE000:
                        sc.p += 6
                        cp = 0x10000 + ((code - 0xD800) << 10) + (lo - 0xDC00)
                        if n + 4 <= cap:
                            out.append(0xF0 | (cp >> 18)); n += 1
                            out.append(0x80 | ((cp >> 12) & 0x3F)); n += 1
                            out.append(0x80 | ((cp >> 6) & 0x3F)); n += 1
                            c = 0x80 | (cp & 0x3F)
                        else:
                            c = ord("?")
                    else:
                        c = ord("?")
                    put(c)
                    continue
                if 0xDC00 <= code < 0xE000:
                    put(ord("?"))
                    continue
                if code < 0x80:
                    c = code
                else:
                    if n + 3 < cap:
                        if code < 0x800:
                            out.append(0xC0 | (code >> 6)); n += 1
                            c = 0x80 | (code & 0x3F)
                        else:
                            out.append(0xE0 | (code >> 12)); n += 1
                            out.append(0x80 | ((code >> 6) & 0x3F)); n += 1
                            c = 0x80 | (code & 0x3F)
                    else:
                        c = ord("?")
            else:
                c = e
        put(c)
    sc.ok = False
    return None


def _parse_string_view(sc: _Scan, cap: int) -> "bytes | None":
    """The C parse_string_view: zero-copy slice when escape-free (clamped
    to cap), unescape fallback otherwise. None = parse failure."""
    _skip_ws(sc)
    buf = sc.buf
    if sc.p >= sc.end or buf[sc.p] != 0x22:
        sc.ok = False
        return None
    s = sc.p + 1
    q = buf.find(b'"', s, sc.end)
    if q < 0:
        sc.ok = False
        return None
    if buf.find(b"\\", s, q) < 0:
        sc.p = q + 1
        raw = buf[s:q]
        return raw[:cap] if len(raw) > cap else raw
    got = _parse_string(sc, cap)
    return None if got is None else bytes(got)


def _skip_container(sc: _Scan, op: int, cl: int) -> None:
    buf = sc.buf
    depth = 1
    sc.p += 1
    while sc.p < sc.end and depth > 0:
        c = buf[sc.p]
        if c == 0x22:
            sc.p += 1
            while sc.p < sc.end and buf[sc.p] != 0x22:
                if buf[sc.p] == 0x5C:
                    sc.p += 1
                sc.p += 1
            if sc.p < sc.end:
                sc.p += 1
            continue
        if c == op:
            depth += 1
        elif c == cl:
            depth -= 1
        sc.p += 1


def _parse_number(sc: _Scan) -> None:
    _skip_ws(sc)
    m = _NUM_RE.match(sc.buf, sc.p, sc.end)
    if m is None or m.end() == sc.p:
        sc.ok = False
        return
    sc.p = m.end()


def _skip_value(sc: _Scan) -> None:
    _skip_ws(sc)
    if sc.p >= sc.end:
        sc.ok = False
        return
    c = sc.buf[sc.p]
    if c == 0x7B:
        _skip_container(sc, 0x7B, 0x7D)
    elif c == 0x5B:
        _skip_container(sc, 0x5B, 0x5D)
    elif c == 0x22:
        _parse_string(sc, 0)
    elif c == ord("t"):
        sc.p += 4
    elif c == ord("f"):
        sc.p += 5
    elif c == ord("n"):
        sc.p += 4
    else:
        _parse_number(sc)


def route_json_payload(payload: bytes, n_ranks: int) -> int:
    """Owning rank of one JSON envelope, or -1 (unroutable -> local).
    Mirrors native route_json_impl exactly."""
    sc = _Scan(payload)
    if not _expect(sc, 0x7B):
        return -1
    first = True
    have_dt = have_hw = False
    h_dt = h_hw = 0
    while sc.ok:
        _skip_ws(sc)
        if sc.p < sc.end and sc.buf[sc.p] == 0x7D:
            sc.p += 1
            break
        if not first and not _expect(sc, 0x2C):
            break
        first = False
        key = _parse_string_view(sc, 512)
        if key is None or not _expect(sc, 0x3A):
            break
        is_dt = key == b"deviceToken"
        is_hw = key == b"hardwareId"
        if is_dt or is_hw:
            _skip_ws(sc)
            if sc.p < sc.end and sc.buf[sc.p] == 0x22:
                # cap mirrors the decoder's sbuf: intern identity is the
                # first 512 token bytes, so the route hash must be too
                val = _parse_string_view(sc, 512)
                if val is None:
                    break
                if is_dt:
                    have_dt = len(val) > 0
                    h_dt = fnv1a_bytes(val)
                else:
                    have_hw = len(val) > 0
                    h_hw = fnv1a_bytes(val)
            else:
                _skip_value(sc)   # non-string token: key is absent
                if is_dt:
                    have_dt = False
                else:
                    have_hw = False
        else:
            _skip_value(sc)
    if have_dt:
        return h_dt % n_ranks
    if have_hw:
        return h_hw % n_ranks
    return -1


def route_binary_payload(payload: bytes, n_ranks: int) -> int:
    """Owning rank of one binary wire payload (native route_binary_impl:
    version byte, u16le token length, strict-UTF-8 token)."""
    if len(payload) < 4 or payload[0] != 1:
        return -1
    (tlen,) = struct.unpack_from("<H", payload, 2)
    tok = payload[4:4 + tlen]
    if len(tok) != tlen:
        return -1
    try:
        tok.decode()
    except UnicodeDecodeError:
        return -1
    return fnv1a_bytes(tok) % n_ranks
