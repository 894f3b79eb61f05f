"""channel_mix_kernel_ms: kernel ms a step launched inside the program's
``model.channel_mix`` spans (the RWKV channel mix: token shift, the
squared-ReLU key and value products, the receptance gate) or
``model.channel_mix.backward`` intervals (its backward on the autograd
thread), by ``spantrace``. Layer: the RWKV channel mix
(``models/recurrent.py`` ``rwkv_channel_mix``)."""
from perfbench import spantrace

MOVES = "step_ms"


def read(ctx):
    a = spantrace.of(ctx)
    if a is None:
        return None
    return a.kernel_ms("model.channel_mix",
                       "model.channel_mix.backward") or None
