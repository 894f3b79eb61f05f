"""ddlerp_kernel_ms: kernel ms a step launched inside the program's
``model.ddlerp`` spans (the RWKV time mix's token shift, its five mixing
LoRAs and its decay LoRA, in float32) or ``model.ddlerp.backward``
intervals (their backward, from the last of the five mixed inputs'
gradients to the normed input's), by ``spantrace``. Layer: the RWKV time
mix (``models/recurrent.py`` ``rwkv_mixer``)."""
from perfbench import spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    if a is None:
        return None
    return a.kernel_ms("model.ddlerp", "model.ddlerp.backward") or None
