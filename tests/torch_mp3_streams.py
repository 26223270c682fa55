"""Synthetic Layer III streams for tests/test_torch_mp3.py: frames whose side
information and spectra are chosen here, so that the decode tests reach
what no encoder on hand writes — intensity stereo (MPEG-1 and the LSF
intensity scalefactor layouts), mixed blocks, dual channel, CRC-protected
frames — and both packages' decoders read the same bits.

Spectra are coded with Huffman table 1 (|x|, |y| <= 1) in the big_values
region and count1 table B, random and seeded; scalefactors are random
within their lengths. Each frame is self-contained (main_data_begin 0)."""

from __future__ import annotations

import numpy as np

SAMPLE_RATES = {0: (44100, 48000, 32000), 1: (22050, 24000, 16000), 2: (11025, 12000, 8000)}
BITRATE_INDEX = {0: (14, 320), 1: (14, 160), 2: (14, 160)}  # (index, kbit/s) of the largest rate
VERSION_BITS = {0: 0b11, 1: 0b10, 2: 0b00}                   # MPEG-1, MPEG-2, MPEG-2.5
MPEG1_SLEN = ((0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4),
              (0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3))
LSF_SFB_COUNT = {0: ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
                 3: ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0))}
TABLE1 = {(0, 0): "1", (0, 1): "001", (1, 0): "01", (1, 1): "000"}


class Bits:
    def __init__(self):
        self.bits: list[str] = []

    def put(self, value: int, n: int) -> None:
        if n:
            self.bits.append(format(value, f"0{n}b"))

    def code(self, s: str) -> None:
        self.bits.append(s)

    def __len__(self) -> int:
        return sum(len(b) for b in self.bits)

    def tobytes(self) -> bytes:
        s = "".join(self.bits)
        s += "0" * (-len(s) % 8)
        return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def crc16(data: bytes) -> int:
    """The Layer III CRC: polynomial 0x8005, initial 0xFFFF, MSB first."""
    crc = 0xFFFF
    for byte in data:
        for k in range(7, -1, -1):
            bit = (byte >> k) & 1
            top = (crc >> 15) & 1
            crc = (crc << 1) & 0xFFFF
            if top ^ bit:
                crc ^= 0x8005
    return crc


def spectrum(rng, big: int, quads: int) -> np.ndarray:
    """Random values in {-1, 0, 1}: `big` lines of big_values, then `quads`
    count1 quadruples, zero after."""
    x = np.zeros(576, np.int64)
    x[:big + 4 * quads] = rng.integers(-1, 2, big + 4 * quads)
    return x


def code_spectrum(bits: Bits, x: np.ndarray, big: int, quads: int) -> None:
    for i in range(0, big, 2):
        a, b = int(x[i]), int(x[i + 1])
        bits.code(TABLE1[(abs(a), abs(b))])
        for v in (a, b):
            if v:
                bits.put(int(v < 0), 1)
    for i in range(big, big + 4 * quads, 4):
        q = [int(v) for v in x[i:i + 4]]
        bits.put(15 - sum(abs(v) << (3 - k) for k, v in enumerate(q)), 4)
        for v in q:
            if v:
                bits.put(int(v < 0), 1)


def stream(version: int, mode: int, mode_ext: int, blocks, seed: int, crc: bool = False,
           is_bound: int = 200, frames: int = 40, is_slen=(3, 3, 3)) -> bytes:
    """`frames` frames at the version's first listed rate for MPEG-1, its
    first (22.05 kHz) for MPEG-2 and its last (8 kHz) for MPEG-2.5, largest
    bitrate; mode 0 stereo, 1 joint (mode_ext: bit 1 M/S, bit 0 intensity),
    2 dual channel, 3 mono. blocks: (block_type, mixed) per granule, cycled.
    With intensity, the right channel's spectrum stops at line is_bound and
    its scalefactors above are intensity positions (illegal ones included);
    in LSF their lengths are is_slen, the illegal position each one's
    largest value."""
    rng = np.random.default_rng(seed)
    lsf = version != 0
    sr_index = 2 if version == 2 else 0
    sr = SAMPLE_RATES[version][sr_index]
    br_index, kbps = BITRATE_INDEX[version]
    nch = 1 if mode == 3 else 2
    frame_bytes = (72 if lsf else 144) * kbps * 1000 // sr
    side_bytes = (9 if nch == 1 else 17) if lsf else (17 if nch == 1 else 32)
    intensity = mode == 1 and mode_ext & 1
    out = bytearray()
    block_iter = iter(blocks * frames * 2)
    for _ in range(frames):
        header = bytes([0xFF, 0xE0 | (VERSION_BITS[version] << 3) | (0b01 << 1) | (0 if crc else 1),
                        (br_index << 4) | (sr_index << 2), (mode << 6) | (mode_ext << 4)])
        side, main = Bits(), Bits()
        side.put(0, 8 if lsf else 9)  # main_data_begin
        side.put(0, (1 if nch == 1 else 2) if lsf else (5 if nch == 1 else 3))
        if not lsf:
            side.put(0, 4 * nch)      # scfsi
        for _gr in range(1 if lsf else 2):
            block_type, mixed = next(block_iter)
            for ch in range(nch):
                right_is = intensity and ch == 1
                lines = is_bound if right_is else 576
                big = min(int(rng.integers(40, 140)) * 2, lines - lines % 2)
                quads = min(int(rng.integers(0, 30)), (lines - big) // 4)
                x = spectrum(rng, big, quads)
                gain = int(rng.integers(150, 175))
                sf_scale = int(rng.integers(0, 2))
                part2 = Bits()
                kind = 0 if block_type != 2 else (2 if mixed else 1)
                if not lsf:
                    compress = 13 if right_is else int(rng.integers(0, 16))  # slen 3, 3 for is_pos
                    s1, s2 = MPEG1_SLEN[0][compress], MPEG1_SLEN[1][compress]
                    if kind == 0:
                        lens = [s1] * 11 + [s2] * 10
                    elif kind == 1:
                        lens = [s1] * 18 + [s2] * 18
                    else:
                        lens = [s1] * 8 + [s1] * 9 + [s2] * 18
                    for n in lens:
                        part2.put(int(rng.integers(0, 1 << n)) if n else 0, n)
                else:
                    if right_is:
                        slen, layout = (*is_slen, 0), 3
                        compress = (((is_slen[0] * 36 + is_slen[1] * 6 + is_slen[2]) << 1)
                                    | int(rng.integers(0, 2)))
                    else:
                        slen, layout = (3, 2, 2, 1), 0
                        compress = ((slen[0] * 5 + slen[1]) << 4) | (slen[2] << 2) | slen[3]
                    for n, count in zip(slen, LSF_SFB_COUNT[layout][kind]):
                        for _ in range(count):
                            part2.put(int(rng.integers(0, 1 << n)) if n else 0, n)
                huff = Bits()
                code_spectrum(huff, x, big, quads)
                side.put(len(part2) + len(huff), 12)
                side.put(big // 2, 9)
                side.put(gain, 8)
                side.put(compress, 9 if lsf else 4)
                if block_type:
                    side.put(1, 1)
                    side.put(block_type, 2)
                    side.put(mixed, 1)
                    side.put(1, 5)
                    side.put(1, 5)
                    for _ in range(3):
                        side.put(int(rng.integers(0, 3)), 3)
                else:
                    side.put(0, 1)
                    for _ in range(3):
                        side.put(1, 5)
                    side.put(int(rng.integers(0, 16)), 4)
                    side.put(int(rng.integers(0, 8)), 3)
                if not lsf:
                    side.put(int(rng.integers(0, 2)), 1)   # preflag
                side.put(sf_scale, 1)
                side.put(1, 1)                             # count1 table B
                main.bits += part2.bits + huff.bits
        side_data = side.tobytes()
        assert len(side_data) == side_bytes
        body = (crc16(header[2:4] + side_data).to_bytes(2, "big") if crc else b"") + side_data
        main_data = main.tobytes()
        room = frame_bytes - 4 - len(body)
        assert len(main_data) <= room, (len(main_data), room)
        out += header + body + main_data + bytes(room - len(main_data))
    return bytes(out)
