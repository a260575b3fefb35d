"""similarity_ms: the program's phase `similarity` (runtime.phase_timer):
the pt_similarity launch, the copy back, Jaccard and the clustering, mean ms
a command of the window."""


def read(run):
    return run.phase_ms("similarity")
