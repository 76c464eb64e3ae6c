"""exec.hop_cells.discover: millions of cells of hop output tables the
sparse executor writes per discovery (each ``exec.hop`` span's
``segments`` times its ``width``, summed, over 1e6: what
``SparseExecutor.hop_cells`` counts); moves ``discovery_s``.  A window
with no ``exec.hop`` span gives nothing to read."""

from perfbench.span_readers import window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    cells = [a["segments"] * a["width"] for _, _, name, _, _, a in spans
             if name == "exec.hop" and a and "segments" in a]
    return sum(cells) / rec["units"] / 1e6 if cells else None
