from .stream_compact import prefix_sum_cuda, prefix_sum_plain
