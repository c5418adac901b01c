"""QR code generation, dependency-free (port of ``sitewhere_tpu/labels/qrcode.py``;
PIL, imported by ``qr_png`` only, rasterizes).

QR model 2, byte mode, EC level M (or L), versions 1-10, Reed-Solomon over
GF(256), mask selection by penalty score: enough for entity-URI payloads
of a few hundred bytes.
"""

from __future__ import annotations

# --- GF(256) arithmetic for Reed-Solomon -------------------------------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _rs_generator(n: int) -> list[int]:
    g = [1]
    for i in range(n):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, _EXP[i])
            g2[j + 1] ^= c
        g = g2
    return g


def _rs_encode(data: list[int], n_ec: int) -> list[int]:
    gen = _rs_generator(n_ec)
    rem = [0] * n_ec
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        for i, g in enumerate(gen[1:]):
            rem[i] ^= _gf_mul(factor, g)
    return rem


# --- capacity tables (versions 1-10) -----------------------------------------
# (total codewords, [EC level] -> (ec codewords per block, group1 blocks,
#  group1 data codewords, group2 blocks, group2 data codewords))

_TABLES: dict[int, dict[str, tuple[int, int, int, int, int]]] = {
    1: {"L": (7, 1, 19, 0, 0), "M": (10, 1, 16, 0, 0)},
    2: {"L": (10, 1, 34, 0, 0), "M": (16, 1, 28, 0, 0)},
    3: {"L": (15, 1, 55, 0, 0), "M": (26, 1, 44, 0, 0)},
    4: {"L": (20, 1, 80, 0, 0), "M": (18, 2, 32, 0, 0)},
    5: {"L": (26, 1, 108, 0, 0), "M": (24, 2, 43, 0, 0)},
    6: {"L": (18, 2, 68, 0, 0), "M": (16, 4, 27, 0, 0)},
    7: {"L": (20, 2, 78, 0, 0), "M": (18, 4, 31, 0, 0)},
    8: {"L": (24, 2, 97, 0, 0), "M": (22, 2, 38, 2, 39)},
    9: {"L": (30, 2, 116, 0, 0), "M": (22, 3, 36, 2, 37)},
    10: {"L": (18, 2, 68, 2, 69), "M": (26, 4, 43, 1, 44)},
}

_ALIGNMENT: dict[int, list[int]] = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
    6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46],
    10: [6, 28, 52],
}

_EC_BITS = {"L": 0b01, "M": 0b00}


def _choose_version(n_bytes: int, ec: str) -> int:
    for version, table in _TABLES.items():
        ecw, g1, d1, g2, d2 = table[ec]
        capacity = g1 * d1 + g2 * d2
        # byte mode header: 4 bits mode + 8 bits count (v1-9) / 16 bits (v10+)
        header_bits = 4 + (16 if version >= 10 else 8)
        if n_bytes * 8 + header_bits <= capacity * 8:
            return version
    raise ValueError(f"payload of {n_bytes} bytes exceeds QR v10/{ec} capacity")


def _encode_data(payload: bytes, version: int, ec: str) -> list[int]:
    ecw, g1, d1, g2, d2 = _TABLES[version][ec]
    n_data = g1 * d1 + g2 * d2
    bits: list[int] = []

    def push(value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    push(0b0100, 4)  # byte mode
    push(len(payload), 16 if version >= 10 else 8)
    for b in payload:
        push(b, 8)
    push(0, min(4, n_data * 8 - len(bits)))  # terminator
    while len(bits) % 8:
        bits.append(0)
    codewords = [
        int("".join(map(str, bits[i: i + 8])), 2) for i in range(0, len(bits), 8)
    ]
    pad = (0xEC, 0x11)
    i = 0
    while len(codewords) < n_data:
        codewords.append(pad[i % 2])
        i += 1

    # split into blocks, compute EC per block, then interleave
    blocks: list[list[int]] = []
    pos = 0
    for _ in range(g1):
        blocks.append(codewords[pos: pos + d1])
        pos += d1
    for _ in range(g2):
        blocks.append(codewords[pos: pos + d2])
        pos += d2
    ec_blocks = [_rs_encode(b, ecw) for b in blocks]
    out: list[int] = []
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(ecw):
        for b in ec_blocks:
            out.append(b[i])
    return out


def _build_matrix(version: int, data: list[int], ec: str, mask: int) -> list[list[int]]:
    size = 17 + 4 * version
    M = [[None] * size for _ in range(size)]  # None = unset

    def set_finder(r: int, c: int) -> None:
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if 0 <= rr < size and 0 <= cc < size:
                    inside = 0 <= dr <= 6 and 0 <= dc <= 6
                    on = inside and (
                        dr in (0, 6) or dc in (0, 6) or (2 <= dr <= 4 and 2 <= dc <= 4)
                    )
                    M[rr][cc] = 1 if on else 0

    set_finder(0, 0)
    set_finder(0, size - 7)
    set_finder(size - 7, 0)

    # timing patterns
    for i in range(8, size - 8):
        v = 1 if i % 2 == 0 else 0
        if M[6][i] is None:
            M[6][i] = v
        if M[i][6] is None:
            M[i][6] = v

    # alignment patterns
    centers = _ALIGNMENT[version]
    for r in centers:
        for c in centers:
            if M[r][c] is not None:
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    on = max(abs(dr), abs(dc)) != 1
                    M[r + dr][c + dc] = 1 if on else 0

    # reserve format info areas + dark module
    for i in range(9):
        if M[8][i] is None:
            M[8][i] = 0
        if M[i][8] is None:
            M[i][8] = 0
    for i in range(8):
        if M[8][size - 1 - i] is None:
            M[8][size - 1 - i] = 0
        if M[size - 1 - i][8] is None:
            M[size - 1 - i][8] = 0
    M[size - 8][8] = 1  # dark module

    # place data bits in the serpentine column pairs
    bits: list[int] = []
    for byte in data:
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    bit_i = 0
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if M[r][c] is None:
                    bit = bits[bit_i] if bit_i < len(bits) else 0
                    bit_i += 1
                    if _mask_on(mask, r, c):
                        bit ^= 1
                    M[r][c] = bit
        upward = not upward
        col -= 2

    _place_format_info(M, size, ec, mask)
    return M


def _mask_on(mask: int, r: int, c: int) -> bool:
    if mask == 0:
        return (r + c) % 2 == 0
    if mask == 1:
        return r % 2 == 0
    if mask == 2:
        return c % 3 == 0
    if mask == 3:
        return (r + c) % 3 == 0
    if mask == 4:
        return (r // 2 + c // 3) % 2 == 0
    if mask == 5:
        return (r * c) % 2 + (r * c) % 3 == 0
    if mask == 6:
        return ((r * c) % 2 + (r * c) % 3) % 2 == 0
    return ((r + c) % 2 + (r * c) % 3) % 2 == 0


def _place_format_info(M: list[list[int]], size: int, ec: str, mask: int) -> None:
    fmt = (_EC_BITS[ec] << 3) | mask
    # BCH(15,5) with generator 0x537, then XOR mask 0x5412
    val = fmt << 10
    g = 0b10100110111
    for i in range(14, 9, -1):
        if val >> i & 1:
            val ^= g << (i - 10)
    bits15 = ((fmt << 10) | val) ^ 0x5412
    fb = [(bits15 >> i) & 1 for i in range(14, -1, -1)]
    # around the top-left finder
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
                (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    for (r, c), b in zip(coords_a, fb):
        M[r][c] = b
    # split copy: below bottom-left + right of top-right
    coords_b = [(size - 1, 8), (size - 2, 8), (size - 3, 8), (size - 4, 8),
                (size - 5, 8), (size - 6, 8), (size - 7, 8),
                (8, size - 8), (8, size - 7), (8, size - 6), (8, size - 5),
                (8, size - 4), (8, size - 3), (8, size - 2), (8, size - 1)]
    for (r, c), b in zip(coords_b, fb):
        M[r][c] = b


def _penalty(M: list[list[int]]) -> int:
    size = len(M)
    score = 0
    for rows in (M, list(map(list, zip(*M)))):  # rows then columns
        for row in rows:
            run = 1
            for i in range(1, size):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + run - 5
                    run = 1
            if run >= 5:
                score += 3 + run - 5
    for r in range(size - 1):
        for c in range(size - 1):
            if M[r][c] == M[r][c + 1] == M[r + 1][c] == M[r + 1][c + 1]:
                score += 3
    pattern = [1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0]
    for seq in (pattern, pattern[::-1]):
        for r in range(size):
            for c in range(size - 10):
                if [M[r][c + i] for i in range(11)] == seq:
                    score += 40
                if [M[c + i][r] for i in range(11)] == seq:
                    score += 40
    dark = sum(sum(row) for row in M)
    ratio = dark * 100 // (size * size)
    score += abs(ratio - 50) // 5 * 10
    return score


def qr_matrix(payload: bytes | str, ec: str = "M") -> list[list[int]]:
    """Encode payload into a QR module matrix (1 = dark)."""
    if isinstance(payload, str):
        payload = payload.encode()
    version = _choose_version(len(payload), ec)
    data = _encode_data(payload, version, ec)
    best, best_score = None, None
    for mask in range(8):
        M = _build_matrix(version, data, ec, mask)
        s = _penalty(M)
        if best_score is None or s < best_score:
            best, best_score = M, s
    return best


def qr_png(payload: bytes | str, scale: int = 8, border: int = 4,
           ec: str = "M") -> bytes:
    """Render a QR code to PNG bytes (PIL)."""
    import io

    from PIL import Image

    M = qr_matrix(payload, ec)
    size = len(M)
    img = Image.new("1", ((size + 2 * border) * scale,) * 2, 1)
    px = img.load()
    for r in range(size):
        for c in range(size):
            if M[r][c]:
                for dr in range(scale):
                    for dc in range(scale):
                        px[(c + border) * scale + dc, (r + border) * scale + dr] = 0
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()
