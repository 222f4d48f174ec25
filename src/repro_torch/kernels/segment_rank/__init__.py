from .segment_rank import segment_rank_cuda, segment_rank_plain
