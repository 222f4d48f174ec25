from .segment_scan import segment_scan_cuda, segment_scan_plain
