"""The hamming work of the traced scan, as the reference's recount tallies
it (`reference/fused_ba.recount`)."""


def count(cfg, mix, out, counts):
    if not counts or not counts["hamming"]["bytes"]:
        return None
    return counts["hamming"]
