"""CIGAR decoding of backtrack step codes (ops/ksw2.decode_cigar and its
native twin) against the ksw_backtrack state mapping."""
import numpy as np


def test_decode_cigar_state_mapping():
    """Direct decode check against the ksw_backtrack mapping (ksw2.h:137):
    0->M, 1->D, 2->I, 3->N(splice)/D, and the dual-affine long-gap
    insertion state 4 -> I (a previous decode mapped 4 to D, corrupting
    every CIGAR whose optimal path used the second gap profile)."""
    from minimap2_chaindp_tpu.ops.ksw2 import decode_cigar

    def rle(cig):
        return [(c >> 4, "MIDN"[c & 0xF]) for c in cig]

    ops = np.array([0, 4, 4, 0, 1, 1, 0, 2, 0], dtype=np.int8)
    want = [(1, "M"), (1, "I"), (1, "M"), (2, "D"),
            (1, "M"), (2, "I"), (1, "M")]
    got = decode_cigar(ops, len(ops), -1, -1, False, 0)
    assert rle(got) == want
    # the pure-python fallback must agree with the native fast path
    # (decode_cigar re-imports decode_cigar_native per call, so patching
    # the module attribute routes this call to the python RLE)
    import unittest.mock as mock
    from minimap2_chaindp_tpu import native as NAT
    with mock.patch.object(NAT, "decode_cigar_native", lambda *a: None):
        got_py = decode_cigar(ops, len(ops), -1, -1, False, 0)
    assert rle(got_py) == want
    # splice mode: 3 -> N, 4 would still be I (cannot occur in exts2)
    ops2 = np.array([0, 3, 3, 0], dtype=np.int8)
    got2 = decode_cigar(ops2, len(ops2), -1, -1, False, 30)
    assert rle(got2) == [(1, "M"), (2, "N"), (1, "M")]
    # without splice, 3 is the long-gap DELETION
    got3 = decode_cigar(ops2, len(ops2), -1, -1, False, 0)
    assert rle(got3) == [(1, "M"), (2, "D"), (1, "M")]
