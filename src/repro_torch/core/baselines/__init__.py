"""The paper's five baseline memory systems (Appendix B), each reproducing
the write critical path of its reference system. Counterpart of the JAX
package's ``core/baselines/``."""
from repro_torch.core.baselines.evermem_like import EverMemLike
from repro_torch.core.baselines.lightmem_like import LightMemLike
from repro_torch.core.baselines.mem0_like import Mem0Like
from repro_torch.core.baselines.memoryos_like import MemoryOSLike
from repro_torch.core.baselines.mempalace_like import MemPalaceLike

ALL_BASELINES = {
    "mem0": Mem0Like,
    "memoryos": MemoryOSLike,
    "evermem": EverMemLike,
    "lightmem": LightMemLike,
    "mempalace": MemPalaceLike,
}
