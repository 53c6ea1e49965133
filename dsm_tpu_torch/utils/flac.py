"""A FLAC decoder in numpy and Python (a copy of ``dsm_tpu/utils/flac.py``).

The reference server takes wav, mp3, ogg and flac uploads
(moshi-server/src/utils.rs:263-305); no FLAC library is assumed, so the
decoder follows the format's specification.

Supported: every subframe type (constant, verbatim, fixed 0-4, LPC 1-32),
both rice residual methods with escape partitions, the four channel
assignments (independent, left/side, right/side, mid/side), wasted bits,
8/16/24-bit samples, variable and fixed blocking.  CRCs are not verified; a
malformed stream raises ValueError from the structural checks.

For files (the offline path and uploads), at a few MB/s: not a streaming
codec.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _Bits:
    """MSB-first bit reader over a bytes object."""

    __slots__ = ("data", "pos")  # pos in BITS

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, n: int) -> int:
        pos = self.pos
        end = pos + n
        if end > len(self.data) * 8:
            raise ValueError("flac: truncated stream")
        out = 0
        # byte-aligned fast path
        byte, off = divmod(pos, 8)
        data = self.data
        remaining = n
        if off:
            take = min(8 - off, remaining)
            cur = data[byte]
            out = (cur >> (8 - off - take)) & ((1 << take) - 1)
            remaining -= take
            byte += 1
        while remaining >= 8:
            out = (out << 8) | data[byte]
            byte += 1
            remaining -= 8
        if remaining:
            out = (out << remaining) | (data[byte] >> (8 - remaining))
        self.pos = end
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def unary(self) -> int:
        """Count zero bits up to the terminating 1."""
        data = self.data
        pos = self.pos
        total_bits = len(data) * 8
        count = 0
        while True:
            if pos >= total_bits:
                raise ValueError("flac: truncated unary code")
            byte, off = divmod(pos, 8)
            cur = data[byte] & (0xFF >> off)
            if cur == 0:
                count += 8 - off
                pos += 8 - off
                continue
            lead = 7 - cur.bit_length() + 1  # leading zeros within masked byte
            lead_in_window = (8 - off) - cur.bit_length()
            count += lead_in_window
            pos += lead_in_window + 1  # consume the 1 bit
            self.pos = pos
            return count

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192,
    14: 16384, 15: 32768,
}

_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}

_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _read_utf8_coded(bits: _Bits) -> int:
    """The frame header's UTF-8-style coded number (frame/sample index)."""
    first = bits.read(8)
    if first < 0x80:
        return first
    n = 0
    probe = first
    while probe & 0x40:
        n += 1
        probe <<= 1
    val = first & (0x3F >> n)
    for _ in range(n):
        cont = bits.read(8)
        if cont & 0xC0 != 0x80:
            raise ValueError("flac: bad coded number")
        val = (val << 6) | (cont & 0x3F)
    return val


def _residual(bits: _Bits, block_size: int, order: int) -> List[int]:
    method = bits.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = bits.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("flac: bad partition order")
    out: List[int] = []
    for p in range(n_parts):
        n = block_size // n_parts - (order if p == 0 else 0)
        param = bits.read(plen)
        if param == escape:
            raw = bits.read(5)
            if raw == 0:
                out.extend([0] * n)
            else:
                out.extend(bits.read_signed(raw) for _ in range(n))
        else:
            for _ in range(n):
                q = bits.unary()
                r = bits.read(param) if param else 0
                v = (q << param) | r
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _predict(warmup: List[int], coeffs: List[int], shift: int,
             residual: List[int]) -> np.ndarray:
    order = len(coeffs)
    n = len(warmup) + len(residual)
    out = np.empty(n, np.int64)
    out[:order] = warmup
    c = np.asarray(coeffs[::-1], np.int64)
    for i, r in enumerate(residual):
        idx = order + i
        pred = int(np.dot(out[idx - order : idx], c)) >> shift
        out[idx] = r + pred
    return out


def _subframe(bits: _Bits, block_size: int, bps: int) -> np.ndarray:
    if bits.read(1):
        raise ValueError("flac: bad subframe padding bit")
    sf_type = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = 1 + bits.unary()
        bps -= wasted
    if sf_type == 0:  # constant
        v = bits.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif sf_type == 1:  # verbatim
        out = np.asarray(
            [bits.read_signed(bps) for _ in range(block_size)], np.int64
        )
    elif 8 <= sf_type <= 12:  # fixed, order 0-4
        order = sf_type - 8
        warmup = [bits.read_signed(bps) for _ in range(order)]
        res = _residual(bits, block_size, order)
        out = _predict(warmup, _FIXED_COEFFS[order], 0, res)
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        warmup = [bits.read_signed(bps) for _ in range(order)]
        precision = bits.read(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid qlp precision")
        shift = bits.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative qlp shift")
        coeffs = [bits.read_signed(precision) for _ in range(order)]
        res = _residual(bits, block_size, order)
        out = _predict(warmup, coeffs, shift, res)
    else:
        raise ValueError(f"flac: reserved subframe type {sf_type}")
    if wasted:
        out = out << wasted
    return out


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """-> (float32 pcm (n, channels) in [-1, 1], sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("flac: bad magic")
    pos = 4
    sample_rate = channels = bps = 0
    # metadata blocks
    while True:
        header = data[pos : pos + 4]
        if len(header) < 4:
            raise ValueError("flac: truncated metadata")
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            bits = _Bits(body)
            bits.read(16)  # min block
            bits.read(16)  # max block
            bits.read(24)  # min frame
            bits.read(24)  # max frame
            sample_rate = bits.read(20)
            channels = bits.read(3) + 1
            bps = bits.read(5) + 1
        pos += 4 + length
        if last:
            break
    if not sample_rate:
        raise ValueError("flac: no STREAMINFO")

    chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
    bits = _Bits(data, pos * 8)
    total_bits = len(data) * 8
    while True:
        # Frames are byte-aligned; stop at EOF or anything that is not a
        # frame sync (trailing padding/garbage ends the stream).
        if bits.pos + 32 > total_bits:
            break
        if _Bits(data, bits.pos).read(14) != 0x3FFE:
            break
        bits.read(14)  # sync
        bits.read(1)  # reserved
        bits.read(1)  # blocking strategy
        bs_code = bits.read(4)
        sr_code = bits.read(4)
        ch_code = bits.read(4)
        ss_code = bits.read(3)
        bits.read(1)  # reserved
        _read_utf8_coded(bits)
        if bs_code == 6:
            block_size = bits.read(8) + 1
        elif bs_code == 7:
            block_size = bits.read(16) + 1
        elif bs_code in _BLOCK_SIZES:
            block_size = _BLOCK_SIZES[bs_code]
        else:
            raise ValueError("flac: reserved block size")
        if sr_code == 12:
            bits.read(8)
        elif sr_code in (13, 14):
            bits.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        bits.read(8)  # header CRC-8 (unverified)

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_subframe(bits, block_size, frame_bps) for _ in range(n_ch)]
        elif ch_code == 8:  # left/side
            left = _subframe(bits, block_size, frame_bps)
            side = _subframe(bits, block_size, frame_bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _subframe(bits, block_size, frame_bps + 1)
            right = _subframe(bits, block_size, frame_bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side: mid = (L+R)>>1, side = L-R
            mid = _subframe(bits, block_size, frame_bps)
            side = _subframe(bits, block_size, frame_bps + 1)
            # L+R and L-R share parity: the dropped LSB of (L+R) is side's.
            mid2 = (mid << 1) | (side & 1)
            subs = [(mid2 + side) >> 1, (mid2 - side) >> 1]
        else:
            raise ValueError("flac: reserved channel assignment")
        if len(subs) != channels:
            raise ValueError("flac: channel count change mid-stream")
        for c, s in enumerate(subs):
            chans[c].append(s)
        bits.align()
        bits.read(16)  # frame CRC-16 (unverified)

    if not chans[0]:
        raise ValueError("flac: no audio frames")
    pcm = np.stack([np.concatenate(c) for c in chans], axis=1)
    scale = float(1 << (bps - 1))
    return (pcm.astype(np.float32) / scale), sample_rate


def decode_flac_file(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_flac(f.read())
