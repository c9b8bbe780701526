from pycusdr_tpu_torch.protocol.benchmark.bench_base import BenchBase, PacketBench
from pycusdr_tpu_torch.protocol.benchmark.bench_fsk import BenchFSK
from pycusdr_tpu_torch.protocol.benchmark.bench_gfsk import BenchGFSK
from pycusdr_tpu_torch.protocol.benchmark.bench_gmsk import BenchGMSK
from pycusdr_tpu_torch.protocol.benchmark.bench_bpsk import BenchBPSK

__all__ = ["BenchBase", "PacketBench", "BenchFSK", "BenchGFSK", "BenchGMSK", "BenchBPSK"]
