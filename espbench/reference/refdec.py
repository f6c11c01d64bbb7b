"""Scalar MPEG-1 reference decoder (numpy, host-side).

A frozen copy of espflix_tpu_torch/core/refdec.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

A from-scratch, readable decoder implementing EXACTLY the integer
semantics of the reference decoder (src/player.cpp) on
contiguous numpy planes instead of the ESP32's strip-chunked buffers.
It is the Python golden model: the C++ oracle (oracle/) and the batched
device decoder (espflix_tpu/models/mpeg1.py) must match it bit-for-bit.

Deliberately mirrored reference behaviors (documented deviations from a
fully general MPEG-1 decoder, all irrelevant for the supported content):

  * B/D pictures are ignored after the picture header (player.cpp:710-717);
  * the first macroblock of a slice advances exactly one position
    regardless of its address increment (inc_mb ignores its argument,
    player.cpp:823-833);
  * custom quant matrices are indexed in raster order as transmitted
    (player.cpp:646-651);
  * the two frame buffers alternate on every picture (player.cpp:692-702),
    so content not written by a picture shows through from two pictures
    ago;
  * output samples are pinned to [0,248] (PIN, player.cpp:183-236).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from espbench.reference import vlc_tables as V
from espbench.reference.bitio import BitReader
from espbench.reference import strict_int as si

I_FRAME, P_FRAME, B_FRAME, D_FRAME = 1, 2, 3, 4
SLICE_FIRST, SLICE_LAST = 0x01, 0xAF
PICTURE, USER_DATA, SEQUENCE_START = 0x00, 0xB2, 0xB3
EXTENSION, SEQUENCE_END, GROUP = 0xB5, 0xB7, 0xB8

_ZZ = V.ZIG_ZAG
_SCALE = V.SCALE_DCT_Q


def idct_ref(b: np.ndarray) -> np.ndarray:
    """The reference's fixed-point 8x8 IDCT (player.cpp:922-996).

    b: int array (64,) of prescaled coefficients (dequant * SCALE_DCT_Q,
    DC as value<<8).  Column pass has no final shift; row pass rounds
    with (+128)>>8.  Exact integer arithmetic, arbitrary precision here
    (values stay well within int32 for legal inputs).
    """
    b = b.astype(np.int64).reshape(8, 8).copy()

    def pass_(m, final):
        # m: (8, 8) operating over axis 0 (columns); vectorized over axis 1
        b1 = m[4]
        b3 = m[2] + m[6]
        b4 = m[5] - m[3]
        tmp1 = m[1] + m[7]
        tmp2 = m[3] + m[5]
        b6 = m[1] - m[7]
        b7 = tmp1 + tmp2
        m0 = m[0]
        x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7
        x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8)
        x1 = m0 - b1
        x2 = (((m[2] - m[6]) * 362 + 128) >> 8) - b3
        x3 = m0 + b1
        y3 = x1 + x2
        y4 = x3 + b3
        y5 = x1 - x2
        y6 = x3 - b3
        y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8)
        out = np.empty_like(m)
        out[0] = b7 + y4
        out[1] = x4 + y3
        out[2] = y5 - x0
        out[3] = y6 - y7
        out[4] = y6 + y7
        out[5] = x0 + y5
        out[6] = y3 - x4
        out[7] = y4 - b7
        if final:
            out = (out + 128) >> 8
        return out

    b = pass_(b, final=False)        # columns
    b = pass_(b.T, final=True).T     # rows
    return b.astype(np.int32)


def idct_float32(b: np.ndarray) -> np.ndarray:
    """The same butterflies in float32 with exact rotation constants and
    one rounding at the end: the lower-precision IDCT of the benchmark's
    control, which breaks the configuration's bit-exact guarantee."""
    m = b.astype(np.float32).reshape(8, 8)
    c8 = np.float32(2 * np.cos(np.pi / 8))
    s8 = np.float32(2 * np.sin(np.pi / 8))
    r2 = np.float32(np.sqrt(2.0))

    def pass_(m):
        b1 = m[4]
        b3 = m[2] + m[6]
        b4 = m[5] - m[3]
        tmp1 = m[1] + m[7]
        tmp2 = m[3] + m[5]
        b6 = m[1] - m[7]
        b7 = tmp1 + tmp2
        x4 = (b6 * c8 - b4 * s8) - b7
        x0 = x4 - (tmp1 - tmp2) * r2
        x1 = m[0] - b1
        x2 = (m[2] - m[6]) * r2 - b3
        x3 = m[0] + b1
        y3, y4, y5, y6 = x1 + x2, x3 + b3, x1 - x2, x3 - b3
        y7 = -x0 - (b4 * c8 + b6 * s8)
        return np.stack([b7 + y4, x4 + y3, y5 - x0, y6 - y7, y6 + y7,
                         x0 + y5, y3 - x4, y4 - b7])

    out = pass_(pass_(m).T).T
    return np.floor(out / np.float32(256) + np.float32(0.5)).astype(np.int32)


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    pts: int = -1
    mode: int = 0


@dataclass
class FramePair:
    """Double-buffered YUV planes (player.cpp:354-362)."""
    width: int
    height: int
    planes: list = field(default_factory=list)

    def __post_init__(self):
        h, w = self.height, self.width
        self.planes = [
            dict(y=np.zeros((h, w), np.uint8),
                 u=np.zeros((h // 2, w // 2), np.uint8),
                 v=np.zeros((h // 2, w // 2), np.uint8))
            for _ in range(2)
        ]


class Mpeg1Decoder:
    """Pull-model ES decoder; feed bytes, collect presented frames."""

    def __init__(self, on_frame=None, idct=idct_ref):
        self.on_frame = on_frame
        self.idct = idct
        # per picture header: the parse's counts (intra MBs, predicted
        # MBs with a vector, zero-vector copies, coded blocks, slices)
        self.pic_stats: list[dict] = []
        self.frames: list[DecodedFrame] = []
        self.fb: FramePair | None = None
        self.fb_index = 0
        self.pts = -1
        self.last_pts = -1
        # sequence state
        self.mb_width = self.mb_height = 0
        self.intra_q = V.DEFAULT_INTRA_Q.copy()
        self.non_intra_q = V.DEFAULT_NON_INTRA_Q.copy()
        # picture state
        self.picture_coding_type = 0
        self.full_pel_forward = 0
        self.forward_r_size = 0
        self.quantizer_scale = 0
        # mb state
        self.mb_x = self.mb_y = 0
        self.y_dc = self.u_dc = self.v_dc = 128
        self.fwd_h = self.fwd_v = 0

    # -- plane access -------------------------------------------------
    @property
    def current(self):
        return self.fb.planes[self.fb_index & 1]

    @property
    def reference(self):
        return self.fb.planes[(self.fb_index + 1) & 1]

    # -- headers --------------------------------------------------------
    def sequence(self, r: BitReader):
        w = r.get(12)
        h = r.get(12)
        r.get(4)   # pel aspect
        r.get(4)   # picture rate
        r.get(18)  # bit rate
        r.get(12)  # marker+vbv+constrained
        if r.get(1):
            self.intra_q = np.array([r.get(8) for _ in range(64)], np.int32)
        else:
            self.intra_q = V.DEFAULT_INTRA_Q.copy()
        if r.get(1):
            self.non_intra_q = np.array(
                [r.get(8) for _ in range(64)], np.int32)
        else:
            self.non_intra_q = V.DEFAULT_NON_INTRA_Q.copy()
        self.mb_width = (w + 15) >> 4
        self.mb_height = (h + 15) >> 4
        if self.fb is None or self.fb.width != self.mb_width * 16 \
                or self.fb.height != self.mb_height * 16:
            self.fb = FramePair(self.mb_width * 16, self.mb_height * 16)

    def gop(self, r: BitReader):
        r.get(25)
        r.get(7)

    def flush_picture(self, mode=0):
        if self.last_pts != -1 or mode:
            p = self.fb.planes[self.fb_index & 1]
            f = DecodedFrame(p["y"].copy(), p["u"].copy(), p["v"].copy(),
                             self.last_pts, mode)
            self.frames.append(f)
            if self.on_frame:
                self.on_frame(f)
            self.fb_index += 1
        if not mode:
            self.last_pts = self.pts

    def picture(self, r: BitReader):
        self.flush_picture()
        r.get(10)  # temporal reference
        self.picture_coding_type = r.get(3)
        self.pic_stats.append(dict(type=self.picture_coding_type, intra=0,
                                   pred=0, copy=0, blocks=0, slices=0))
        if self.picture_coding_type not in (I_FRAME, P_FRAME):
            return
        r.get(16)  # vbv_delay
        if self.picture_coding_type == P_FRAME:
            self.full_pel_forward = r.get(1)
            self.forward_r_size = r.get(3) - 1

    # -- VLC reads ------------------------------------------------------
    def get_vlc(self, r: BitReader, lut: np.ndarray, peek_bits: int) -> int:
        e = int(lut[r.peek(peek_bits)])
        assert e != 0, f"invalid VLC at bit {r.pos}"
        r.skip(V.lut_length(e))
        return V.lut_value(e)

    # -- macroblock layer -------------------------------------------------
    def reset_predictors(self):
        self.y_dc = self.u_dc = self.v_dc = 128
        self.fwd_h = self.fwd_v = 0

    def inc_mb(self):
        self.mb_x += 1
        while self.mb_x >= self.mb_width:
            self.mb_x -= self.mb_width
            self.mb_y += 1

    def motion_vector(self, r: BitReader, m: int, r_size: int) -> int:
        scale = 1 << r_size
        code = self.get_vlc(r, V.LUT_MOTION, 11)
        if code != 0 and scale != 1:
            d = ((abs(code) - 1) << r_size) + r.get(r_size) + 1
            if code < 0:
                d = -d
        else:
            d = code
        m += d
        if m > (scale << 4) - 1:
            m -= scale << 5
        elif m < (-scale) << 4:
            m += scale << 5
        return m

    def mocomp_plane(self, src: np.ndarray, dst: np.ndarray, pos_x: int,
                     pos_y: int, size: int, dst_x: int, dst_y: int):
        """Half-pel motion compensation, exact rounding of
        player.cpp:732-821 ((a+b+1)>>1 and (a+b+c+d+2)>>2)."""
        xy = ((pos_y & 1) << 1) | (pos_x & 1)
        x0, y0 = pos_x >> 1, pos_y >> 1
        need = size + 1
        assert 0 <= y0 and y0 + (need if xy >> 1 else size) <= src.shape[0], \
            (y0, size, src.shape)
        assert 0 <= x0 and x0 + (need if xy & 1 else size) <= src.shape[1]
        a = src[y0:y0 + size, x0:x0 + size].astype(np.int32)
        if xy == 0:
            out = a
        elif xy == 1:
            b = src[y0:y0 + size, x0 + 1:x0 + 1 + size].astype(np.int32)
            out = (a + b + 1) >> 1
        elif xy == 2:
            c = src[y0 + 1:y0 + 1 + size, x0:x0 + size].astype(np.int32)
            out = (a + c + 1) >> 1
        else:
            b = src[y0:y0 + size, x0 + 1:x0 + 1 + size].astype(np.int32)
            c = src[y0 + 1:y0 + 1 + size, x0:x0 + size].astype(np.int32)
            d = src[y0 + 1:y0 + 1 + size, x0 + 1:x0 + 1 + size].astype(
                np.int32)
            out = (a + b + c + d + 2) >> 2
        dst[dst_y:dst_y + size, dst_x:dst_x + size] = out.astype(np.uint8)

    def _count(self, key: str):
        if self.pic_stats:
            self.pic_stats[-1][key] += 1

    def predict_zero(self):
        self._count("copy")
        cur, ref = self.current, self.reference
        y, x = self.mb_y * 16, self.mb_x * 16
        cur["y"][y:y + 16, x:x + 16] = ref["y"][y:y + 16, x:x + 16]
        cur["u"][y // 2:y // 2 + 8, x // 2:x // 2 + 8] = \
            ref["u"][y // 2:y // 2 + 8, x // 2:x // 2 + 8]
        cur["v"][y // 2:y // 2 + 8, x // 2:x // 2 + 8] = \
            ref["v"][y // 2:y // 2 + 8, x // 2:x // 2 + 8]

    def predict(self):
        h, v = self.fwd_h, self.fwd_v
        if h == 0 and v == 0:
            self.predict_zero()
            return
        self._count("pred")
        if self.full_pel_forward:
            h <<= 1
            v <<= 1
        cur, ref = self.current, self.reference
        x = (self.mb_x << 5) + h
        y = (self.mb_y << 5) + v
        self.mocomp_plane(ref["y"], cur["y"], x, y, 16,
                          self.mb_x * 16, self.mb_y * 16)
        x >>= 1
        y >>= 1
        self.mocomp_plane(ref["u"], cur["u"], x, y, 8,
                          self.mb_x * 8, self.mb_y * 8)
        self.mocomp_plane(ref["v"], cur["v"], x, y, 8,
                          self.mb_x * 8, self.mb_y * 8)

    def _dc_size(self, r: BitReader, luma: bool) -> int:
        return self.get_vlc(
            r, V.LUT_DC_LUM if luma else V.LUT_DC_CHROM, 8)

    def block(self, r: BitReader, blk: int, intra: bool):
        """Decode one 8x8 block (player.cpp:999-1148)."""
        self._count("blocks")
        q = self.non_intra_q
        n = 0
        b = np.zeros(64, np.int32)

        if intra:
            if blk < 4:
                b[0] = self.y_dc
                dc_size = self._dc_size(r, True)
            else:
                b[0] = self.u_dc if blk == 4 else self.v_dc
                dc_size = self._dc_size(r, False)
            if dc_size:
                delta = r.get(dc_size)
                b[0] = si.dc_delta(int(b[0]), dc_size, delta)
                if blk == 4:
                    self.u_dc = int(b[0])
                elif blk == 5:
                    self.v_dc = int(b[0])
                else:
                    self.y_dc = int(b[0])
            b[0] <<= 8
            q = self.intra_q
            n = 1

        while True:
            p = r.peek(2)
            if n and p == 0x2:
                r.skip(2)  # EOB
                break
            lut = V.LUT_DCT_FIRST if n == 0 else V.LUT_DCT_NEXT
            kind, bits, run, level = V.unpack_dct(int(lut[r.peek(17)]))
            assert kind != V.DCT_KIND_INVALID, f"bad dct code at {r.pos}"
            r.skip(bits)
            if kind == V.DCT_KIND_ESCAPE:
                v8 = r.get(8)
                if v8 == 0:
                    level = r.get(8)
                elif v8 == 128:
                    level = r.get(8) - 256
                else:
                    level = v8 - 256 if v8 > 128 else v8
            n += run
            if n >= 64:
                raise ValueError("coefficient index out of range")
            zz = int(_ZZ[n])
            n += 1
            vq = si.dequant_array(int(level), intra, self.quantizer_scale,
                                  int(q[zz]))
            b[zz] = vq * int(_SCALE[zz])

        # destination
        cur = self.current
        if blk < 4:
            plane = cur["y"]
            dx = self.mb_x * 16 + (8 if blk & 1 else 0)
            dy = self.mb_y * 16 + (8 if blk & 2 else 0)
        else:
            plane = cur["u"] if blk == 4 else cur["v"]
            dx, dy = self.mb_x * 8, self.mb_y * 8

        if n == 1:
            dc = int(b[0]) >> 8
            region = plane[dy:dy + 8, dx:dx + 8]
            if intra:
                plane[dy:dy + 8, dx:dx + 8] = si.pin_248(
                    np.full((8, 8), dc, np.int32)).astype(np.uint8)
            else:
                plane[dy:dy + 8, dx:dx + 8] = si.pin_248(
                    region.astype(np.int32) + dc).astype(np.uint8)
            return

        out = self.idct(b)
        region = plane[dy:dy + 8, dx:dx + 8]
        if intra:
            plane[dy:dy + 8, dx:dx + 8] = si.pin_248(out).astype(np.uint8)
        else:
            plane[dy:dy + 8, dx:dx + 8] = si.pin_248(
                region.astype(np.int32) + out).astype(np.uint8)

    def slice_done(self, r: BitReader) -> bool:
        # reference checks its 32-bit cache for trailing zeros
        # (player.cpp:1238-1249); with in-memory buffers peek(23)==0 is
        # the operative condition for well-formed streams.
        return r.peek(23) == 0

    def slice(self, r: BitReader, s: int):
        self.mb_y = s - 2
        self.mb_x = self.mb_width - 1  # corrected on first increment
        if self.mb_y >= self.mb_height:
            return -1
        self.reset_predictors()
        self._count("slices")
        self.quantizer_scale = r.get(5)
        while r.get(1):
            r.get(8)

        mb = 0
        while not self.slice_done(r):
            increment = 0
            i = self.get_vlc(r, V.LUT_MB_ADDR, 11)
            while i == V.MB_STUFFING:
                i = self.get_vlc(r, V.LUT_MB_ADDR, 11)
            while i == V.MB_ESCAPE:
                increment += 33
                i = self.get_vlc(r, V.LUT_MB_ADDR, 11)
            increment += i

            if mb == 0:
                self.inc_mb()  # reference ignores the count here
            else:
                if increment > 1:
                    self.reset_predictors()
                while increment > 1:
                    self.inc_mb()
                    self.predict_zero()
                    increment -= 1
                self.inc_mb()

            lut = V.LUT_MB_TYPE_I if self.picture_coding_type == I_FRAME \
                else V.LUT_MB_TYPE_P
            mb_type = self.get_vlc(r, lut, 6)
            intra = bool(mb_type & V.MBT_INTRA)
            if intra:
                self._count("intra")

            if mb_type & V.MBT_QUANT:
                self.quantizer_scale = r.get(5)

            if intra:
                self.fwd_h = self.fwd_v = 0
            else:
                self.y_dc = self.u_dc = self.v_dc = 128
                if mb_type & V.MBT_MOTION_F:
                    self.fwd_h = self.motion_vector(
                        r, self.fwd_h, self.forward_r_size)
                    self.fwd_v = self.motion_vector(
                        r, self.fwd_v, self.forward_r_size)
                else:
                    self.fwd_h = self.fwd_v = 0
                self.predict()

            if mb_type & V.MBT_PATTERN:
                cbp = self.get_vlc(r, V.LUT_CBP, 9)
            else:
                cbp = 63 if intra else 0

            mask = 0x20
            for i in range(6):
                if cbp & mask:
                    self.block(r, i, intra)
                mask >>= 1
            mb += 1
        return 0

    # -- top level -------------------------------------------------------
    def decode_es(self, data: bytes, pts_per_picture=None,
                  flush_final=True) -> list:
        """Decode a whole elementary stream; returns presented frames.

        pts_per_picture: optional callable(picture_index) -> pts,
        emulating the PES layer's PTS stamping.  flush_final presents the
        last decoded picture at stream end (the reference leaves it
        pending until the next picture or an explicit flush,
        player.cpp:692-702).
        """
        r = BitReader(data)
        npic = 0
        try:
            while r.pos < 8 * len(data):
                # start-code scan (player.cpp:1355-1367)
                while r.peek(24) == 0:
                    r.skip(1)
                    if r.pos >= 8 * len(data):
                        return self.frames
                if r.peek(24) != 1:
                    r.skip(8)
                    continue
                r.skip(24)
                m = r.get(8)
                if m == SEQUENCE_START:
                    self.sequence(r)
                elif m == GROUP:
                    self.gop(r)
                elif m == PICTURE:
                    if pts_per_picture is not None:
                        self.pts = pts_per_picture(npic)
                    else:
                        self.pts = npic
                    npic += 1
                    self.picture(r)
                elif m == SEQUENCE_END:
                    break
                elif m in (USER_DATA, EXTENSION):
                    pass
                elif SLICE_FIRST <= m <= SLICE_LAST:
                    self.slice(r, m)
        finally:
            if flush_final:
                self.flush_picture()
        return self.frames
