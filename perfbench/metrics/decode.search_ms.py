"""Mean host ms a window batch spends in the decode fn handed to the
batch loop (decode_init + beam search; the search syncs every step)."""


def read(w):
    if w.batches == 0 or "decode_fn" not in w.spans:
        return None
    return w.spans["decode_fn"] / w.batches * 1e3
