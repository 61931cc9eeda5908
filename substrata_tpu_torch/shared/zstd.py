"""Zstandard frames in the standard library alone (RFC 8878).

The reference's bmesh and igmesh codecs call the ``zstandard`` package,
which the port does not depend on.  ``decompress`` reads any zstd frame:
raw, RLE and compressed blocks (Huffman-coded literals, FSE-coded
sequences, repeat offsets, tables carried from block to block), skippable
frames, and several frames one after another; it checks no checksum and
supports no dictionary.  ``compress`` writes one single-segment frame
with its content size: an RLE block where a block is one repeated byte,
else a compressed block where that is smaller than the stored one —
literals stored raw (or as one repeated byte), sequences from a greedy
LZ77 match finder (a hash of 4-byte prefixes over the whole frame, no
repeat offsets) coded with the format's predefined FSE tables — and a
stored block otherwise.  Both work on ``bytes`` at Python speed, which
suits meshes of up to a few hundred kilobytes.
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
MAX_BLOCK = 1 << 17


class ZstdError(ValueError):
    pass


def compress(data: bytes) -> bytes:
    """One frame holding ``data``, with its content size."""
    data = bytes(data)
    n = len(data)
    if n >= 1 << 32:
        raise ZstdError("content of 4 GiB or more")
    out = [struct.pack("<IB", MAGIC, 0xA0), struct.pack("<I", n)]  # single segment, 4-byte size
    finder = _MatchFinder(data)
    pos = 0
    while True:
        size = min(MAX_BLOCK, n - pos)
        last = int(pos + size >= n)
        chunk = data[pos:pos + size]
        if size and chunk.count(chunk[0]) == size:
            out.append((last | (1 << 1) | (size << 3)).to_bytes(3, "little") + chunk[:1])
            finder.skip(pos + size)
        else:
            body = _compressed_block(finder.sequences(pos, pos + size), data, pos, pos + size)
            if len(body) < size:
                out.append((last | (2 << 1) | (len(body) << 3)).to_bytes(3, "little") + body)
            else:
                out.append((last | (size << 3)).to_bytes(3, "little") + chunk)
        pos += size
        if last:
            return b"".join(out)


# ---------------------------------------------------------------------------
# Compressed blocks: greedy LZ77, predefined FSE tables
# ---------------------------------------------------------------------------

MIN_MATCH = 4
MAX_OFFSET_CODE = 28        # the predefined offset table's last symbol


class _MatchFinder:
    """Greedy longest-prefix matches against everything before them in the
    frame, through a table of the last position of each 4-byte prefix."""

    def __init__(self, data: bytes):
        self.data = data
        self.table: dict[bytes, int] = {}
        self.pos = 0

    def skip(self, end: int):
        """Index positions up to ``end`` without emitting anything."""
        d, table = self.data, self.table
        for p in range(self.pos, min(end, len(d) - MIN_MATCH + 1)):
            table[d[p:p + MIN_MATCH]] = p
        self.pos = end

    def sequences(self, start: int, end: int):
        """(literal length, offset, match length) of the block [start, end);
        the literals after the last match are left for the block."""
        d, table = self.data, self.table
        seqs = []
        anchor = p = start
        limit = end - MIN_MATCH
        while p <= limit:
            key = d[p:p + MIN_MATCH]
            cand = table.get(key)
            table[key] = p
            if cand is None or (p - cand + 3).bit_length() - 1 > MAX_OFFSET_CODE:
                p += 1
                continue
            m = MIN_MATCH
            while p + m < end and d[cand + m] == d[p + m]:
                m += 1
            seqs.append((p - anchor, p - cand, m))
            for q in range(p + 1, min(p + m, len(d) - MIN_MATCH + 1)):
                table[d[q:q + MIN_MATCH]] = q
            p += m
            anchor = p
        self.pos = end
        for q in range(max(p, start), min(end, len(d) - MIN_MATCH + 1)):
            table[d[q:q + MIN_MATCH]] = q
        return seqs


def _code(value: int, base) -> int:
    """The length code whose base is the largest not above ``value``."""
    lo, hi = 0, len(base) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if base[mid] <= value:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _fse_encoder(counts, log):
    """(state table, per-symbol (delta_nb_bits, delta_find_state)) of the
    predefined distribution, as zstd's FSE_buildCTable builds them; the
    symbol spread is ``_fse_table``'s, so the decoder walks the same
    states."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    cumul = [0]
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
        cumul.append(cumul[-1] + (1 if c == -1 else c))
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    states = [0] * size
    nxt = cumul[:-1]
    for u in range(size):
        states[nxt[sym[u]]] = size + u
        nxt[sym[u]] += 1
    transform = []
    total = 0
    for c in counts:
        if c in (-1, 1):
            transform.append(((log << 16) - size, total - 1))
            total += 1
        elif c == 0:
            transform.append((((log + 1) << 16) - size, 0))
        else:
            max_bits = log - ((c - 1).bit_length() - 1)
            transform.append(((max_bits << 16) - (c << max_bits), total - c))
            total += c
    return states, transform, log


_ENCODERS = None


def _encoders():
    global _ENCODERS
    if _ENCODERS is None:
        _ENCODERS = tuple(_fse_encoder(*t) for t in (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT))
    return _ENCODERS


class _BitWriter:
    """A forward bit accumulator; ``close`` adds the end marker."""

    def __init__(self):
        self.acc = 0
        self.n = 0

    def add(self, value: int, bits: int):
        self.acc |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits

    def close(self) -> bytes:
        self.add(1, 1)
        return self.acc.to_bytes((self.n + 7) >> 3, "little")


class _FseState:
    def __init__(self, enc, symbol: int):
        self.states, self.transform, self.log = enc
        dnb, dfs = self.transform[symbol]
        nb = (dnb + (1 << 15)) >> 16
        self.value = self.states[(((nb << 16) - dnb) >> nb) + dfs]

    def encode(self, bw: _BitWriter, symbol: int):
        dnb, dfs = self.transform[symbol]
        nb = (self.value + dnb) >> 16
        bw.add(self.value, nb)
        self.value = self.states[(self.value >> nb) + dfs]

    def flush(self, bw: _BitWriter):
        bw.add(self.value, self.log)


def _literals_section(lits: bytes) -> bytes:
    n = len(lits)
    kind = 1 if n and lits.count(lits[0]) == n else 0          # RLE or raw
    if n < 32:
        head = bytes([kind | (n << 3)])
    elif n < 4096:
        head = bytes([kind | (1 << 2) | ((n & 15) << 4), n >> 4])
    else:
        head = bytes([kind | (3 << 2) | ((n & 15) << 4), (n >> 4) & 0xFF, n >> 12])
    return head + (lits[:1] if kind else lits)


def _compressed_block(seqs, data: bytes, start: int, end: int) -> bytes:
    lits = bytearray()
    p = start
    for ll, _off, ml in seqs:
        lits += data[p:p + ll]
        p += ll + ml
    lits += data[p:end]
    out = bytearray(_literals_section(bytes(lits)))
    n = len(seqs)
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out += bytes([(n >> 8) + 128, n & 0xFF])
    else:
        out += bytes([255, (n - 0x7F00) & 0xFF, (n - 0x7F00) >> 8])
    if n == 0:
        return bytes(out)
    out.append(0)                                   # all three tables predefined
    codes = []
    for ll, off, ml in seqs:
        of_value = off + 3
        codes.append((_code(ll, LL_BASE), of_value.bit_length() - 1, _code(ml, ML_BASE)))
    ll_enc, of_enc, ml_enc = _encoders()
    bw = _BitWriter()

    def extras(i):
        ll, off, ml = seqs[i]
        llc, ofc, mlc = codes[i]
        bw.add(ll - LL_BASE[llc], LL_BITS[llc])
        bw.add(ml - ML_BASE[mlc], ML_BITS[mlc])
        bw.add(off + 3 - (1 << ofc), ofc)

    llc, ofc, mlc = codes[-1]
    ml_st, of_st, ll_st = _FseState(ml_enc, mlc), _FseState(of_enc, ofc), _FseState(ll_enc, llc)
    extras(n - 1)
    for i in range(n - 2, -1, -1):
        llc, ofc, mlc = codes[i]
        of_st.encode(bw, ofc)
        ml_st.encode(bw, mlc)
        ll_st.encode(bw, llc)
        extras(i)
    ml_st.flush(bw)
    of_st.flush(bw)
    ll_st.flush(bw)
    out += bw.close()
    return bytes(out)


# ---------------------------------------------------------------------------
# Bit readers
# ---------------------------------------------------------------------------

class _Backward:
    """A zstd backward bitstream: read from the end, after the final byte's
    padding marker (its highest set bit).  Bits past the start read as
    zeros, and ``pos`` goes negative there."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos -= n
        return v

    def peek(self, n: int) -> int:
        lo = self.pos - n
        if lo >= 0:
            b0, b1 = lo >> 3, (self.pos - 1) >> 3
            return (int.from_bytes(self.data[b0:b1 + 1], "little") >> (lo & 7)) & ((1 << n) - 1)
        if self.pos <= 0:
            return 0
        v = int.from_bytes(self.data[:((self.pos - 1) >> 3) + 1], "little") & ((1 << self.pos) - 1)
        return v << (-lo)


class _Forward:
    def __init__(self, data: bytes, start: int = 0):
        self.data = data
        self.bit = 8 * start

    def read(self, n: int) -> int:
        b0 = self.bit >> 3
        v = int.from_bytes(self.data[b0:b0 + 8], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------

def _read_ncount(data: bytes, start: int, max_symbol: int):
    """An FSE table description: (normalised counts, accuracy log, bytes read)."""
    br = _Forward(data, start)
    log = br.read(4) + 5
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            n0 = len(counts)
            rep = br.read(2)
            while rep == 3:
                n0 += 3
                rep = br.read(2)
            n0 += rep
            counts += [0] * (n0 - len(counts))
            if len(counts) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        b0 = br.bit >> 3
        v = int.from_bytes(data[b0:b0 + 8], "little") >> (br.bit & 7)
        if (v & (threshold - 1)) < mx:
            c = v & (threshold - 1)
            br.bit += nb - 1
        else:
            c = v & (2 * threshold - 1)
            if c >= threshold:
                c -= mx
            br.bit += nb
        c -= 1
        remaining -= -c if c < 0 else c
        counts.append(c)
        prev0 = c == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, ((br.bit + 7) >> 3) - start


def _fse_table(counts, log):
    """Decoding table: per state (symbol, bits, baseline)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("corrupt FSE table")
    table = []
    for u in range(size):
        s = sym[u]
        ns = nxt[s]
        nxt[s] += 1
        bits = log - (ns.bit_length() - 1)
        table.append((s, bits, (ns << bits) - size))
    return table, log


def _rle_table(symbol):
    return [(symbol, 0, 0)], 0


LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1], 5)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                             2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

def _huffman_table(data: bytes, pos: int):
    """The tree description at ``pos``: (table indexed by max_bits bits of
    (symbol, bits), max_bits, bytes read)."""
    h = data[pos]
    if h < 128:
        counts, log, n = _read_ncount(data, pos + 1, 255)
        table, _ = _fse_table(counts, log)
        br = _Backward(data[pos + 1 + n:pos + 1 + h])
        s1, s2 = br.read(log), br.read(log)
        weights = []
        while True:
            sym, bits, base = table[s1]
            weights.append(sym)
            s1 = base + br.read(bits)
            if br.pos < 0:
                weights.append(table[s2][0])
                break
            sym, bits, base = table[s2]
            weights.append(sym)
            s2 = base + br.read(bits)
            if br.pos < 0:
                weights.append(table[s1][0])
                break
            if len(weights) > 255:
                raise ZstdError("corrupt Huffman weights")
        used = 1 + h
    else:
        n = h - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
        used = 1 + (n + 1) // 2
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("corrupt Huffman tree")
    weights.append(rest.bit_length())
    table = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return table, max_bits, used


def _huffman_stream(data: bytes, n: int, table, max_bits: int, out: bytearray):
    br = _Backward(data)
    for _ in range(n):
        s, bits = table[br.peek(max_bits)]
        out.append(s)
        br.pos -= bits
    if br.pos != 0:
        raise ZstdError("Huffman stream not fully read")


# ---------------------------------------------------------------------------
# Blocks and frames
# ---------------------------------------------------------------------------

class _Frame:
    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]       # literal lengths, offsets, match lengths
        self.rep = [1, 4, 8]

    def literals(self, data: bytes, pos: int):
        b0 = data[pos]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind < 2:
            if fmt in (0, 2):
                size, pos = b0 >> 3, pos + 1
            elif fmt == 1:
                size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
            else:
                size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
                pos += 3
            if kind == 0:
                return data[pos:pos + size], pos + size
            return bytes([data[pos]]) * size, pos + 1
        hdr, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
        h = int.from_bytes(data[pos:pos + hdr], "little")
        regen = (h >> 4) & ((1 << bits) - 1)
        comp = (h >> (4 + bits)) & ((1 << bits) - 1)
        pos += hdr
        end = pos + comp
        if kind == 2:
            table, max_bits, used = _huffman_table(data, pos)
            self.huffman = (table, max_bits)
            pos += used
        elif self.huffman is None:
            raise ZstdError("treeless literals without a previous Huffman table")
        table, max_bits = self.huffman
        out = bytearray()
        if fmt == 0:
            _huffman_stream(data[pos:end], regen, table, max_bits, out)
        else:
            s1, s2, s3 = struct.unpack_from("<3H", data, pos)
            pos += 6
            each = (regen + 3) // 4
            for k, size in enumerate((s1, s2, s3, end - pos - s1 - s2 - s3)):
                _huffman_stream(data[pos:pos + size], each if k < 3 else regen - 3 * each,
                                table, max_bits, out)
                pos += size
        if len(out) != regen:
            raise ZstdError("literal count")
        return bytes(out), end

    def table(self, k, mode, data, pos, default, max_symbol):
        if mode == 0:
            self.tables[k] = _fse_table(*default)
        elif mode == 1:
            self.tables[k] = _rle_table(data[pos])
            pos += 1
        elif mode == 2:
            counts, log, n = _read_ncount(data, pos, max_symbol)
            self.tables[k] = _fse_table(counts, log)
            pos += n
        elif self.tables[k] is None:
            raise ZstdError("repeat mode without a previous table")
        return pos

    def block(self, data: bytes, out: bytearray):
        lits, pos = self.literals(data, 0)
        n = data[pos]
        if n == 0:
            out += lits
            return
        if n < 128:
            pos += 1
        elif n < 255:
            n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
        else:
            n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
        modes = data[pos]
        pos += 1
        pos = self.table(0, modes >> 6, data, pos, LL_DEFAULT, 35)
        pos = self.table(1, (modes >> 4) & 3, data, pos, OF_DEFAULT, 31)
        pos = self.table(2, (modes >> 2) & 3, data, pos, ML_DEFAULT, 52)
        (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = self.tables
        br = _Backward(data[pos:])
        ll_s, of_s, ml_s = br.read(ll_log), br.read(of_log), br.read(ml_log)
        rep = self.rep
        lit = 0
        for i in range(n):
            ll_code, ll_bits, ll_base = ll_t[ll_s]
            of_code, of_bits, of_base = of_t[of_s]
            ml_code, ml_bits, ml_base = ml_t[ml_s]
            ofv = (1 << of_code) + br.read(of_code)
            ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code])
            ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code])
            if ofv > 3:
                off = ofv - 3
                rep[:] = [off, rep[0], rep[1]]
            else:
                k = ofv - 1 + (ll == 0)
                if k == 0:
                    off = rep[0]
                elif k == 1:
                    off = rep[1]
                    rep[:] = [off, rep[0], rep[2]]
                elif k == 2:
                    off = rep[2]
                    rep[:] = [off, rep[0], rep[1]]
                else:
                    off = rep[0] - 1
                    rep[:] = [off, rep[0], rep[1]]
            if i + 1 < n:
                ll_s = ll_base + br.read(ll_bits)
                ml_s = ml_base + br.read(ml_bits)
                of_s = of_base + br.read(of_bits)
            out += lits[lit:lit + ll]
            lit += ll
            start = len(out) - off
            if off <= 0 or start < 0:
                raise ZstdError("match offset out of range")
            while ml > 0:
                take = min(ml, off)
                out += out[start:start + take]
                start += take
                ml -= take
        if br.pos != 0:
            raise ZstdError("sequence stream not fully read")
        out += lits[lit:]


def decompress(data: bytes, max_output_size: int | None = None) -> bytes:
    """The content of every frame in ``data``, concatenated."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(data):
        magic, = struct.unpack_from("<I", data, pos)
        if magic & 0xFFFFFFF0 == 0x184D2A50:             # skippable frame
            size, = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise ZstdError("not a zstd frame")
        desc = data[pos + 4]
        pos += 5
        single = (desc >> 5) & 1
        if not single:
            pos += 1                                        # window descriptor
        if desc & 3:
            raise ZstdError("dictionaries are not supported")
        fcs_flag = desc >> 6
        pos += (1 if single else 0) if fcs_flag == 0 else (2, 4, 8)[fcs_flag - 1]
        frame = _Frame()
        while True:
            h = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, kind, size = h & 1, (h >> 1) & 3, h >> 3
            if kind == 0:
                out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                out += bytes([data[pos]]) * size
                pos += 1
            elif kind == 2:
                frame.block(data[pos:pos + size], out)
                pos += size
            else:
                raise ZstdError("reserved block type")
            if max_output_size is not None and len(out) > max_output_size:
                raise ZstdError("content larger than max_output_size")
            if last:
                break
        if (desc >> 2) & 1:
            pos += 4                                        # content checksum
    return bytes(out)
