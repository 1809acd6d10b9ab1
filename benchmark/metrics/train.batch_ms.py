"""``RAGModel.build_batch("jsa")`` (both query towers, the search, the
union, the tokenisation): the host's time from the call to a synchronise
after it, the window's total over its steps divided by its steps (ms a
step)."""


def read(rec):
    xs = rec.window.spans.get("train.batch_ms")
    return sum(xs) / len(xs) if xs else None
