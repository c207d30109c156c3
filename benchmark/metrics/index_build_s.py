"""Host wall around ``DeltaPQIndex(codewords, codes)`` in set-up: the tree
build, its layout and serialization (the engine is built at the first
search, in the warm-up)."""


def read(run):
    return run.index_build_s
