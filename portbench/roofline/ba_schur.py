"""The ba_schur work of the traced scan, as the reference's recount tallies
it (`reference/fused_ba.recount`)."""


def count(cfg, mix, out, counts):
    if not counts or not counts["ba_schur"]["bytes"]:
        return None
    return counts["ba_schur"]
