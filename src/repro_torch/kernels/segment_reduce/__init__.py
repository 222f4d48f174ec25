from .segment_reduce import segment_sums_cuda, segment_sums_plain
