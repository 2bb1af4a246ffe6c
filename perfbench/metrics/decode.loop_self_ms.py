"""Mean host ms a window batch spends in the batch loop outside the
decode fn: batch formation, the feature copy, detokenizing."""


def read(w):
    if w.batches == 0 or "decode_fn" not in w.spans:
        return None
    return (w.seconds - w.spans["decode_fn"]) / w.batches * 1e3
