"""``torch.cuda.max_memory_allocated()`` over the window, in GiB: the
inputs the cell holds and the steps' working memory."""


def read(run):
    return run.peak_bytes / 2 ** 30
