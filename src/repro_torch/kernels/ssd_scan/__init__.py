from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ops import SSDScan, ssd_chunked, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_reference, ssd_reference_bwd

__all__ = ["SSDScan", "ssd_chunked", "ssd_reference", "ssd_reference_bwd", "ssd_scan",
           "ssd_scan_bwd_cuda", "ssd_scan_cuda"]
