from .stencil1d import (segment_stencil_cuda, segment_stencil_plain,
                        stencil1d_cuda, stencil1d_exact_cuda,
                        stencil1d_exact_plain, stencil1d_plain)
