"""cards.idle_share: the largest, over the cell's cards, of a card's idle
share (%) of its window: from its first batch's start to its last batch's
end, the gaps between one batch's end event and the next batch's start
event, all taken from that card's own events (hopbench/loop.py: each
batch's `card_ms`)."""


def read(ctx):
    bs = [b for b in ctx.window.batches if b.card_ms]
    if len(bs) < 2:
        return None
    shares = []
    for c in range(len(bs[0].card_ms)):
        span = bs[-1].card_ms[c][1] - bs[0].card_ms[c][0]
        gaps = sum(max(0.0, b.card_ms[c][0] - a.card_ms[c][1]) for a, b in zip(bs, bs[1:]))
        shares.append(100.0 * gaps / span)
    return max(shares)
