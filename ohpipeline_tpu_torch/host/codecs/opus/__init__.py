"""Opus codec: Ogg Opus (RFC 7845) framing over the from-spec CELT
decoder (RFC 6716 s4.3).

Parity target: OpenHome/Media/Codec/Opus.cpp (adapter over vendored
opus-1.5.2 + libogg).  The full mode matrix decodes: CELT-only
streams (music; all frame sizes 120..960 @48 kHz, mono/stereo)
bit-conformant vs the compiled reference (tests/test_opus_celt.py,
tests/test_opus.py); SILK-only streams (speech; NB/MB/WB,
mono/stereo, 10-60 ms packets, LBRR skipped) through the SILK LP
decoder + 48 kHz resampler chain, SNR-conformant vs the reference
(tests/test_opus_silk.py); and hybrid SWB/FB speech (WB SILK core +
CELT bands 17+ sharing one range coder).  Packet loss runs the
reference's concealment (SILK fixed-point PLC bit-exact, CELT float
pitch extrapolation), in-band LBRR FEC reconstructs lost SILK frames,
and mode switches decode the RFC 6716 s4.5 CELT redundancy frames
with smooth_fade crossfades (switch-heavy streams track opus_decode
at >=80 dB per packet, tests/test_opus_silk.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...containers.ogg import OggReader
from ...core.jiffies import Jiffies
from ...core.streaminfo import PcmStreamInfo
from ..base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                    StreamReader)
from ..opus_headers import OpusHead, OpusToc, parse_opus_head, \
    parse_opus_tags, parse_toc
from .celt import CeltDecoderState, decode_frame, decode_lost

GROUP_PACKETS = 32

#: CELT end band per Opus bandwidth (opus_decoder.c -> CELT_SET_END_BAND)
_END_BAND = {"nb": 13, "mb": 17, "wb": 17, "swb": 19, "fb": 21}


def split_packet_frames(packet: bytes) -> tuple[OpusToc, list[bytes]]:
    """RFC 6716 s3.2 packet -> frames."""
    if not packet:
        raise CodecStreamCorrupt("empty opus packet")
    toc = parse_toc(packet)
    code = packet[0] & 3
    body = packet[1:]

    def read_len(buf, p):
        if p >= len(buf):
            raise CodecStreamCorrupt("truncated opus frame length")
        v = buf[p]
        p += 1
        if v >= 252:
            if p >= len(buf):
                raise CodecStreamCorrupt("truncated opus frame length")
            v += 4 * buf[p]
            p += 1
        return v, p

    if code == 0:
        frames = [body]
    elif code == 1:
        if len(body) % 2:
            raise CodecStreamCorrupt("code-1 packet with odd length")
        h = len(body) // 2
        frames = [body[:h], body[h:]]
    elif code == 2:
        ln, p = read_len(body, 0)
        frames = [body[p:p + ln], body[p + ln:]]
    else:
        if not body:
            raise CodecStreamCorrupt("empty code-3 packet")
        fc = body[0]
        m = fc & 0x3F
        vbr = fc & 0x80
        pad = fc & 0x40
        p = 1
        padding = 0
        if pad:
            while True:
                if p >= len(body):
                    raise CodecStreamCorrupt("truncated opus padding")
                v = body[p]
                p += 1
                padding += v if v < 255 else 254
                if v < 255:
                    break
        if vbr:
            if m == 0:
                raise CodecStreamCorrupt("bad VBR code-3 packet")
            lens = []
            for _ in range(m - 1):
                ln, p = read_len(body, p)
                lens.append(ln)
            avail = len(body) - p - padding
            last = avail - sum(lens)
            if last < 0:
                raise CodecStreamCorrupt("bad VBR code-3 lengths")
            lens.append(last)
            frames = []
            for ln in lens:
                frames.append(body[p:p + ln])
                p += ln
        else:
            avail = len(body) - p - padding
            if m == 0 or avail % m:
                raise CodecStreamCorrupt("bad CBR code-3 packet")
            ln = avail // m
            frames = [body[p + i * ln:p + (i + 1) * ln] for i in range(m)]
    return toc, frames


class _OpusStream:
    """Decode state across packets of one Ogg Opus stream."""

    def __init__(self, head: OpusHead):
        self.head = head
        self.celt: Optional[CeltDecoderState] = None
        self.silk = None
        self.stream_channels = 0
        self.gain = 10.0 ** (head.output_gain_q8 / (20.0 * 256.0))
        self.prev_toc: Optional[OpusToc] = None    # PLC uses last mode
        self.prev_mode: Optional[str] = None       # transition detection
        self.prev_redundancy = False

    @staticmethod
    def _smooth_fade(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """2.5 ms squared-window crossfade (opus_decoder.c
        smooth_fade): out = (1-w^2)*a + w^2*b over 120 samples."""
        from .celt import celt_mode
        w = celt_mode().window[:120] ** 2
        return a * (1.0 - w) + b * w

    def _decode_redundant(self, data: bytes, sc: int, reset: bool,
                          end_band: int = 21) -> np.ndarray:
        """Decode the 5 ms CELT redundancy frame appended at a mode
        switch (opus_decoder.c:822-871); start_band 0, fresh CELT
        state when entering CELT from SILK (OPUS_RESET_STATE), end band
        from the packet's signalled bandwidth (CELT_SET_END_BAND runs
        before the redundancy decode, opus_decoder.c:500-525)."""
        if self.celt is None or reset or self.stream_channels != sc:
            self.celt = CeltDecoderState(sc)
            self.stream_channels = sc
        return decode_frame(self.celt, data, 240, end_band=end_band)

    def _apply_redundancy(self, pcm: np.ndarray, red: np.ndarray,
                          celt_to_silk: bool) -> np.ndarray:
        """RFC 6716 section 4.5 crossfade: entering SILK from CELT the
        redundant audio covers the frame start (copy 2.5 ms, fade
        2.5 ms); leaving SILK toward CELT the frame's last 2.5 ms fades
        into the redundant frame's second half
        (opus_decoder.c:934-960)."""
        F2_5 = 120
        if pcm.shape[1] < 2 * F2_5 or red.shape[1] < 2 * F2_5:
            return pcm
        if red.shape[0] != pcm.shape[0]:
            red = (np.repeat(red, pcm.shape[0], axis=0)
                   if red.shape[0] == 1 else 0.5 * (red[:1] + red[1:]))
        if celt_to_silk:
            pcm[:, :F2_5] = red[:, :F2_5]
            pcm[:, F2_5:2 * F2_5] = self._smooth_fade(
                red[:, F2_5:2 * F2_5], pcm[:, F2_5:2 * F2_5])
        else:
            pcm[:, -F2_5:] = self._smooth_fade(
                pcm[:, -F2_5:], red[:, F2_5:2 * F2_5])
        return pcm

    def _apply_transition(self, pcm: np.ndarray,
                          trans: np.ndarray) -> np.ndarray:
        """Mode switch without redundancy: crossfade from 5 ms of
        old-mode concealment (opus_decoder.c:962-984)."""
        F2_5 = 120
        if pcm.shape[1] < 2 * F2_5 or trans.shape[1] < 2 * F2_5:
            return pcm
        if trans.shape[0] != pcm.shape[0]:
            trans = (np.repeat(trans, pcm.shape[0], axis=0)
                     if trans.shape[0] == 1
                     else 0.5 * (trans[:1] + trans[1:]))
        pcm[:, :F2_5] = trans[:, :F2_5]
        pcm[:, F2_5:2 * F2_5] = self._smooth_fade(
            trans[:, F2_5:2 * F2_5], pcm[:, F2_5:2 * F2_5])
        return pcm

    def _decode_silk(self, toc: OpusToc, frames: list,
                     transition: bool = False) -> np.ndarray:
        from .range_dec import RangeDecoder
        from .silk import SilkStereoDecoder, SilkStreamDecoder
        dur = int(toc.frame_ms)
        if dur not in (10, 20, 40, 60):
            raise CodecStreamCorrupt(f"bad SILK duration {toc.frame_ms}")
        # leaving a CELT-only run resets the whole LP layer
        # (opus_decoder.c:389-390 silk_ResetDecoder)
        if self.prev_mode == "celt":
            self.silk = None
        stereo_layer = (toc.stereo or self.head.channels == 2
                        or isinstance(self.silk, SilkStereoDecoder))
        if stereo_layer:
            # mid/side layer (also carries mono packets of a switching
            # stream through its mid history buffer, like silk_Decode)
            if not isinstance(self.silk, SilkStereoDecoder) \
                    or self.silk.bw != toc.bandwidth:
                self.silk = SilkStereoDecoder(toc.bandwidth)
        else:
            if self.silk is None or not isinstance(
                    self.silk, SilkStreamDecoder) \
                    or self.silk.bw != toc.bandwidth:
                self.silk = SilkStreamDecoder(toc.bandwidth)
        outs = []
        for f in frames:
            dec = RangeDecoder(f)
            if stereo_layer:
                pcm = self.silk.decode_packet_48k(f, toc.stereo, dur,
                                                  dec=dec)
            else:
                pcm = self.silk.decode_frame_48k(f, dur,
                                                 dec=dec)[None, :]
            pcm = pcm.astype(np.float64)
            # SILK-only redundancy: implied by leftover bits
            # (opus_decoder.c:780-806: >= 17 bits -> redundancy, the
            # duplicate CELT 5 ms frame rides the tail raw bytes)
            redundancy = False
            celt_to_silk = False
            red = None
            if dec.tell() + 17 <= 8 * len(f):
                celt_to_silk = bool(dec.dec_bit_logp(1))
                red_bytes = len(f) - ((dec.tell() + 7) >> 3)
                if 2 <= red_bytes <= len(f):
                    redundancy = True
                    sc = 2 if toc.stereo else 1
                    red = self._decode_redundant(
                        f[len(f) - red_bytes:], sc,
                        reset=not celt_to_silk,
                        end_band=_END_BAND[toc.bandwidth]) * 32768.0
            # hybrid -> SILK: decode a silence frame so the CELT MDCT
            # fades out the high bands (opus_decoder.c:566-575)
            if self.prev_mode == "hybrid" and self.celt is not None \
                    and not (redundancy and celt_to_silk
                             and self.prev_redundancy):
                fade = decode_frame(self.celt, b"\xff\xff", 120,
                                    start_band=0,
                                    end_band=_END_BAND[toc.bandwidth])
                if fade.shape[0] != pcm.shape[0]:
                    fade = (np.repeat(fade, pcm.shape[0], axis=0)
                            if fade.shape[0] == 1
                            else 0.5 * (fade[:1] + fade[1:]))
                pcm[:, :120] += fade * 32768.0
            if red is not None and (not celt_to_silk
                                    or self.prev_mode != "silk"
                                    or self.prev_redundancy):
                # a CELT->SILK redundancy frame is decoded but unused
                # when the previous frame was already plain SILK (its
                # own redundancy may have been lost, opus_decoder.c:601)
                pcm = self._apply_redundancy(pcm, red, celt_to_silk)
            if not redundancy and transition:
                trans = self.conceal_packet(5) * 32768.0 / self.gain
                pcm = self._apply_transition(pcm, trans)
            transition = False
            self.prev_mode = "silk"
            self.prev_redundancy = redundancy and not celt_to_silk
            outs.append(pcm)
        return np.concatenate(outs, axis=1) * (1.0 / 32768.0)

    def _decode_hybrid(self, toc: OpusToc, frames: list,
                       transition: bool = False) -> np.ndarray:
        """Hybrid (SWB/FB speech) frame: a WB SILK core and CELT bands
        17+ share one range coder (src/opus_decoder.c:380-612); the
        outputs are summed.  Redundant CELT frames at mode switches are
        decoded and crossfaded per RFC 6716 section 4.5."""
        from .range_dec import RangeDecoder
        from .silk import SilkStereoDecoder, SilkStreamDecoder
        dur = int(toc.frame_ms)
        if dur not in (10, 20):
            raise CodecStreamCorrupt(f"bad hybrid duration {toc.frame_ms}")
        sc = 2 if toc.stereo else 1
        if self.celt is None or sc != self.stream_channels:
            self.celt = CeltDecoderState(sc)
            self.stream_channels = sc
        # leaving a CELT-only run resets the whole LP layer
        # (opus_decoder.c:389-390 silk_ResetDecoder)
        if self.prev_mode == "celt":
            self.silk = None
        outs = []
        for f in frames:
            dec = RangeDecoder(f)
            if toc.stereo or isinstance(self.silk, SilkStereoDecoder):
                if not isinstance(self.silk, SilkStereoDecoder) \
                        or self.silk.bw != "wb":
                    self.silk = SilkStereoDecoder("wb")
                silk48 = self.silk.decode_packet_48k(f, toc.stereo, dur,
                                                     dec=dec)
            else:
                if not isinstance(self.silk, SilkStreamDecoder) \
                        or self.silk.bw != "wb":
                    self.silk = SilkStreamDecoder("wb")
                silk48 = self.silk.decode_frame_48k(f, dur,
                                                    dec=dec)[None, :]
            eff = len(f)
            redundancy = False
            celt_to_silk = False
            rb = 0
            if dec.tell() + 37 <= 8 * len(f):
                if dec.dec_bit_logp(12):          # redundancy present
                    celt_to_silk = bool(dec.dec_bit_logp(1))
                    rb = dec.dec_uint(256) + 2
                    eff -= rb
                    dec.storage -= rb             # shrink raw-bit window
                    redundancy = True
            # the transition concealment extrapolates the OLD mode's
            # state, so it runs before the CELT reset below
            # (opus_decoder.c:493-497)
            trans = None
            if not redundancy and transition:
                trans = self.conceal_packet(5) * 32768.0 / self.gain
            red = None
            if redundancy and celt_to_silk:
                # decode BEFORE the main CELT frame so the shared CELT
                # state carries over from the previous CELT-mode packet
                red = self._decode_redundant(
                    f[eff:eff + rb], sc, reset=False,
                    end_band=_END_BAND[toc.bandwidth]) * 32768.0
            # discard CELT state on an un-protected mode change
            # (opus_decoder.c:551-553 OPUS_RESET_STATE)
            if self.prev_mode not in (None, "hybrid") \
                    and not self.prev_redundancy:
                self.celt = CeltDecoderState(sc)
                self.stream_channels = sc
            celt_out = decode_frame(
                self.celt, f[:eff], int(toc.frame_ms * 48), dec=dec,
                start_band=17, end_band=_END_BAND[toc.bandwidth])
            if silk48.shape[0] != celt_out.shape[0]:
                silk48 = np.repeat(silk48, celt_out.shape[0], axis=0)
            pcm = silk48 + celt_out * 32768.0
            if redundancy and not celt_to_silk:
                red = self._decode_redundant(
                    f[eff:eff + rb], sc, reset=True,
                    end_band=_END_BAND[toc.bandwidth]) * 32768.0
            if red is not None and (not celt_to_silk
                                    or self.prev_mode != "silk"
                                    or self.prev_redundancy):
                pcm = self._apply_redundancy(pcm, red, celt_to_silk)
            if trans is not None:
                pcm = self._apply_transition(pcm, trans)
            transition = False
            self.prev_mode = "hybrid"
            self.prev_redundancy = redundancy and not celt_to_silk
            outs.append(pcm * (1.0 / 32768.0))
        return np.concatenate(outs, axis=1)

    def conceal_packet(self, duration_ms: int = 20) -> np.ndarray:
        """Conceal one lost packet (the opus_decode(NULL, ...) path):
        SILK modes run the fixed-point PLC (silk/PLC.c via
        native.silk_frame_fix), CELT mode runs pitch/noise
        extrapolation (celt_decode_lost), hybrid conceals the SILK
        core (the CELT 17+ band tail decays with it)."""
        from .silk import SilkStereoDecoder, SilkStreamDecoder
        C = self.head.channels
        n48 = int(duration_ms * 48)
        # PLC runs the last mode, CELT if the last frame carried
        # SILK->CELT redundancy (opus_decoder.c:299-300)
        mode = "celt" if self.prev_redundancy else self.prev_mode
        if mode is None:
            return np.zeros((C, n48))
        if mode in ("silk", "hybrid"):
            # the SILK PLC cannot run under 10 ms (opus_decoder.c:393);
            # shorter conceals take the head of a 10 ms PLC frame
            plc_ms = max(10, duration_ms)
            if isinstance(self.silk, SilkStereoDecoder):
                pcm = self.silk.conceal_packet_48k(plc_ms)
            elif isinstance(self.silk, SilkStreamDecoder):
                pcm = self.silk.conceal_frame_48k(plc_ms)[None, :]
            else:
                pcm = np.zeros((1, n48))
            pcm = pcm[:, :n48] * (1.0 / 32768.0) * self.gain
        else:
            if self.celt is None:
                return np.zeros((C, n48))
            outs = []
            left = n48
            while left > 0:
                n = min(left, 960)
                outs.append(decode_lost(self.celt, n))
                left -= n
            pcm = np.concatenate(outs, axis=1) * self.gain
        if pcm.shape[0] == 1 and C == 2:
            pcm = np.repeat(pcm, 2, axis=0)
        elif pcm.shape[0] == 2 and C == 1:
            pcm = 0.5 * (pcm[:1] + pcm[1:])
        return pcm

    def decode_packet_fec(self, packet: bytes) -> np.ndarray:
        """Recover the PREVIOUS (lost) packet's audio from this
        packet's in-band FEC (opus_decode decode_fec=1).  SILK-only
        packets use their LBRR data; other modes fall back to
        concealment for the packet's duration."""
        from .silk import SilkStereoDecoder, SilkStreamDecoder
        toc, frames = split_packet_frames(packet)
        dur = int(toc.frame_ms) * max(1, len(frames)) \
            if toc.frame_ms >= 10 else 20
        if toc.mode == "silk" and not toc.stereo \
                and isinstance(self.silk, SilkStreamDecoder) \
                and self.silk.bw == toc.bandwidth:
            outs = [self.silk.decode_fec_48k(f, int(toc.frame_ms))
                    for f in frames]
            pcm = np.concatenate(outs)[None, :] * (1.0 / 32768.0) \
                * self.gain
            C = self.head.channels
            if C == 2:
                pcm = np.repeat(pcm, 2, axis=0)
            return pcm
        return self.conceal_packet(dur)

    def decode_packet(self, packet: Optional[bytes],
                      lost_duration_ms: int = 20) -> np.ndarray:
        if packet is None:
            return self.conceal_packet(lost_duration_ms)
        toc, frames = split_packet_frames(packet)
        # mode transition without redundancy: conceal 5 ms of the old
        # mode to fade from (opus_decoder.c:341-353; entering CELT the
        # fade only applies when the previous packet carried no
        # SILK->CELT redundancy).  The SILK/hybrid paths defer the
        # concealment until this frame's redundancy bit is known
        # (redundancy suppresses the transition, opus_decoder.c:485-489)
        transition = self.prev_mode is not None and (
            (toc.mode == "celt" and self.prev_mode != "celt"
             and not self.prev_redundancy)
            or (toc.mode != "celt" and self.prev_mode == "celt"))
        if toc.mode in ("silk", "hybrid"):
            if toc.mode == "silk":
                pcm = self._decode_silk(toc, frames,
                                        transition=transition) * self.gain
            else:
                pcm = self._decode_hybrid(toc, frames,
                                          transition=transition) \
                    * self.gain
            self.prev_toc = toc
            C = self.head.channels
            if pcm.shape[0] == 1 and C == 2:
                pcm = np.repeat(pcm, 2, axis=0)
            elif pcm.shape[0] == 2 and C == 1:
                # (L+R)/2 equals the mid channel exactly
                pcm = 0.5 * (pcm[:1] + pcm[1:])
            return pcm
        # entering CELT: conceal before the state reset so the fade
        # extrapolates the old mode (opus_decoder.c:355-363)
        trans_pcm = self.conceal_packet(5) if transition else None
        sc = 2 if toc.stereo else 1
        if self.celt is None or sc != self.stream_channels:
            # stream channel switches reset the CELT state (the reference
            # re-creates its decoder on stream param changes)
            self.celt = CeltDecoderState(sc)
            self.stream_channels = sc
        elif self.prev_mode not in (None, "celt") \
                and not self.prev_redundancy:
            # un-protected switch into CELT discards the stale state
            # (opus_decoder.c:551-553 OPUS_RESET_STATE)
            self.celt = CeltDecoderState(sc)
        frame_size = int(toc.frame_ms * 48)
        outs = [decode_frame(self.celt, f, frame_size,
                             end_band=_END_BAND[toc.bandwidth])
                for f in frames]
        pcm = np.concatenate(outs, axis=1) * self.gain
        if trans_pcm is not None:
            pcm = self._apply_transition(pcm, trans_pcm)
        self.prev_toc = toc
        self.prev_mode = toc.mode
        self.prev_redundancy = False
        C = self.head.channels
        if pcm.shape[0] == 1 and C == 2:
            pcm = np.repeat(pcm, 2, axis=0)
        elif pcm.shape[0] == 2 and C == 1:
            pcm = 0.5 * (pcm[:1] + pcm[1:])
        return pcm


class CodecOpus(CodecBase):
    """Ogg Opus (reference CodecOpus, Media/Codec/Opus.cpp:429)."""

    name = "Opus"
    recognition_cost = 44
    mime_types = ("audio/opus", "audio/ogg; codecs=opus")

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None

    def recognise(self, header: bytes) -> bool:
        if header[:4] != b"OggS":
            return False
        return b"OpusHead" in header[:128]

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._ogg = OggReader(reader)
        self._packets = self._ogg.packets()
        try:
            self._head = parse_opus_head(next(self._packets))
            _vendor, self.tags = parse_opus_tags(next(self._packets))
        except (StopIteration, ValueError) as e:
            raise CodecStreamCorrupt(f"opus headers: {e}")
        if self._head.version >> 4 != 0:
            raise CodecStreamCorrupt("unsupported OpusHead version")
        if self._head.mapping_family != 0:
            raise CodecStreamCorrupt("opus surround mapping unsupported")
        self._stream = _OpusStream(self._head)
        self._skip = self._head.pre_skip
        self._sample_pos = 0
        self._done = False
        nbytes = reader.stream_bytes or 0
        total_jiffies = 0
        # Ogg Opus duration needs the last page granule; estimate from
        # size at a typical music bitrate when streaming (like Vorbis)
        if nbytes:
            seconds = nbytes * 8 / 128000
            total_jiffies = int(seconds * Jiffies.kPerSecond)
        self._info = PcmStreamInfo(
            sample_rate=48000, bit_depth=16,
            num_channels=self._head.channels, codec_name="Opus",
            lossless=False, seekable=False, bitrate=0,
            track_length_jiffies=total_jiffies)
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._done:
            raise EndOfStream
        packets = []
        for p in self._packets:
            packets.append(p)
            if len(packets) >= GROUP_PACKETS:
                break
        if not packets:
            raise EndOfStream
        if len(packets) < GROUP_PACKETS:
            self._done = True
        stream = self._stream
        first = self._sample_pos
        skip = self._skip
        granule = self._ogg.last_granule

        def run():
            parts = [stream.decode_packet(p) for p in packets]
            out = np.concatenate(parts, axis=1)
            if skip:
                drop = min(skip, out.shape[1])
                out = out[:, drop:]
                self._skip = skip - drop
            if self._done and granule >= 0:
                # RFC 7845: granule counts 48k samples incl. pre-skip
                keep = max(0, int(granule) - self._head.pre_skip - first)
                if out.shape[1] > keep:
                    out = out[:, :keep]
            self._sample_pos = first + out.shape[1]
            return np.clip(np.rint(out * 32768.0),
                           -32768, 32767).astype(np.int32)

        return DecodedBatch(self._info, defer=run,
                            track_offset_samples=first)


def parse_dops(body: bytes) -> OpusHead:
    """OpusSpecificBox ('dOps') payload -> OpusHead-equivalent params
    (opus-in-isobmff section 4.3.2; the reference reads the same 11
    bytes, Media/Codec/Opus.cpp:72-84,391-430).  Big-endian, unlike the
    little-endian Ogg OpusHead."""
    if len(body) < 11:
        raise CodecStreamCorrupt("short dOps box")
    version = body[0]
    if version != 0:
        raise CodecStreamCorrupt(f"dOps version {version}")
    channels = body[1]
    pre_skip = int.from_bytes(body[2:4], "big")
    input_rate = int.from_bytes(body[4:8], "big")
    output_gain_q8 = int.from_bytes(body[8:10], "big", signed=True)
    mapping_family = body[10]
    return OpusHead(version=0, channels=channels, pre_skip=pre_skip,
                    input_rate=input_rate, output_gain_q8=output_gain_q8,
                    mapping_family=mapping_family)


class CodecOpusMp4(CodecBase):
    """Opus in MP4/ISO-BMFF ('Opus' sample entry + 'dOps' config) —
    the flavour the reference's CodecOpus actually decodes: Opus served
    under (fragmented) MPEG-4/DASH, one Opus packet per MP4 sample,
    sample sizes from the moov tables or re-read per moof fragment
    (Media/Codec/Opus.cpp:94-98,158-281).  Plain .opus (Ogg) streams are
    handled by CodecOpus above (beyond-reference: the reference punts on
    those, Opus.cpp:102-110)."""

    name = "Opus-MP4"
    recognition_cost = 26
    mime_types = ("audio/x-opus-mpeg", "audio/mp4; codecs=opus")

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None

    def recognise(self, header: bytes) -> bool:
        if len(header) < 12 or header[4:8] != b"ftyp":
            return False
        from ...containers.mpeg4 import find_audio_track
        try:
            track = find_audio_track(header)
        except Exception:                                 # noqa: BLE001
            return False
        return track is not None and track.codec == "Opus"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        from ...containers.mpeg4 import (find_audio_track,
                                         iter_fragment_samples)
        self._data = reader.read(reader.stream_bytes or (1 << 30))
        track = find_audio_track(self._data)
        if track is None or track.codec != "Opus":
            raise CodecStreamCorrupt("no Opus track")
        self._head = parse_dops(track.codec_config)
        if self._head.mapping_family != 0:
            raise CodecStreamCorrupt("opus surround mapping unsupported")
        # moov sample tables when present; fragmented streams carry the
        # sizes in each moof's trun instead (reference: TryReadSizeTable
        # per fragment, Opus.cpp:264-281)
        self._samples = list(track.sample_offsets())
        if not self._samples:
            self._samples = list(iter_fragment_samples(
                self._data, track_id=track.track_id))
        self._index = 0
        self._stream = _OpusStream(self._head)
        self._skip = self._head.pre_skip
        self._sample_pos = 0
        # Opus always decodes at 48 kHz; mdhd duration counts timescale
        # ticks (usually 48000 for Opus tracks)
        total_jiffies = 0
        self._total_48k = 0
        if track.duration and track.timescale:
            self._total_48k = (track.duration * 48000
                               + track.timescale - 1) // track.timescale
            total_jiffies = int(track.duration * Jiffies.kPerSecond
                                // track.timescale)
        self._info = PcmStreamInfo(
            sample_rate=48000, bit_depth=16,
            num_channels=self._head.channels, codec_name="Opus",
            lossless=False, seekable=False, bitrate=0,
            track_length_jiffies=total_jiffies)
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._index >= len(self._samples):
            raise EndOfStream
        packets = []
        while (self._index < len(self._samples)
               and len(packets) < GROUP_PACKETS):
            off, size = self._samples[self._index]
            self._index += 1
            packets.append(self._data[off:off + size])
        stream = self._stream
        first = self._sample_pos
        skip = self._skip
        last = self._index >= len(self._samples)

        def run():
            parts = [stream.decode_packet(p) for p in packets]
            out = np.concatenate(parts, axis=1)
            if skip:
                drop = min(skip, out.shape[1])
                out = out[:, drop:]
                self._skip = skip - drop
            if last and self._total_48k:
                keep = max(0, self._total_48k - self._head.pre_skip
                           - first)
                if out.shape[1] > keep:
                    out = out[:, :keep]
            self._sample_pos = first + out.shape[1]
            return np.clip(np.rint(out * 32768.0),
                           -32768, 32767).astype(np.int32)

        return DecodedBatch(self._info, defer=run,
                            track_offset_samples=first)


def decode_opus_mp4(data: bytes) -> tuple[PcmStreamInfo, np.ndarray]:
    """Whole-buffer Opus-in-MP4 decode (tests/tools)."""
    from ..base import BufferReader
    codec = CodecOpusMp4()
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))


def decode_opus(data: bytes) -> tuple[PcmStreamInfo, np.ndarray]:
    """Whole-buffer Ogg Opus decode (tests/tools)."""
    from ..base import BufferReader
    codec = CodecOpus()
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))
