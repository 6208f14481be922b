"""Output tokens all requests received in the window (first tokens and
decode tokens, by the request ledger's stamps) over the window's seconds."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["tokens"] else None
