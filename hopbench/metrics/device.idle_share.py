"""device.idle_share: the share (%) of the window's device span, from the
first batch's start to the last batch's end, in which no batch ran: the
gaps between one batch's end event and the next batch's start event."""


def read(ctx):
    bs = [b for b in ctx.window.batches if b.start_ms is not None]
    if len(bs) < 2:
        return None
    span = bs[-1].end_ms - bs[0].start_ms
    gaps = sum(max(0.0, b.start_ms - a.end_ms) for a, b in zip(bs, bs[1:]))
    return 100.0 * gaps / span
