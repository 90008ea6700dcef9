"""Work of the AAC-LC kernels, counted by the reference's parse of the
content."""

from __future__ import annotations

from ..reference import aac as R


def _tns_lines(ch: R.ChannelData, rate_index: int) -> tuple[int, int]:
    """(spectral lines filtered, multiply-adds) of one channel's TNS
    filters, bounded as ``reference.aac.apply_tns`` bounds them."""
    offsets = R.sfb_offsets(rate_index, ch.ics.short)
    nbands = len(offsets) - 1
    lines = taps = 0
    for filters in ch.tns:
        bottom = nbands
        for length, order, _direction, _coeffs in filters:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = min(int(offsets[min(top, nbands)]),
                      128 if ch.ics.short else 1024)
            if end > start:
                lines += end - start
                taps += (end - start) * order
    return lines, taps


def per_request(content: dict, cell: dict) -> dict:
    """{kernel name: {"bytes", "ops"}} that one serving call's streams need.

    ``tns_rows`` (``csrc/tns.cu``) filters the channels with TNS that the
    wire carries (a channel with a PNS or intensity band is prepared on
    the host instead): each filtered line is read and written once as
    float32, and each tap is a multiply and an add."""
    memo: dict = {}
    lines = taps = 0
    for stream in content["streams"]:
        for frame in R.split_frames(stream):
            if frame not in memo:
                fr = R.parse_frame(frame)
                memo[frame] = [0, 0]
                for ch in fr.channels:
                    if ch.tns is None or (ch.band_cb >= R.NOISE_CB).any():
                        continue
                    n, t = _tns_lines(ch, fr.rate_index)
                    memo[frame][0] += n
                    memo[frame][1] += t
            lines += memo[frame][0]
            taps += memo[frame][1]
    return {"tns_rows": {"bytes": 8.0 * lines, "ops": 2.0 * taps}}
