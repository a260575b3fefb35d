"""pt_similarity (panacus_torch/csrc/group.cu): the weighted co-occurrence of
every pair of groups over a membership matrix M (one uint32 word a 32 groups
an item) on the int8 tensor cores, as int32 partial tiles
(`similarity_kernel`) that `similarity_reduce_kernel` adds into the int64
result. The least bytes of one command: M of the nodes read once, the int32
weight row once, and the int64 result, 32 groups a word on each side,
written once; the partial tiles are the kernel's own and not counted."""

import math

KERNELS = ("similarity_kernel", "similarity_reduce_kernel")


def matches(name: str) -> bool:
    return any(k in name for k in KERNELS)


def least_bytes(shape: dict) -> int:
    words = math.ceil(shape["n_groups"] / 32)
    return 4 * words * shape["n_nodes"] + 4 * shape["n_nodes"] + 8 * (32 * words) ** 2
