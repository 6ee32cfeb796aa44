"""One optimizer step's forward, loss and backward as a CUDA graph.

``compile(steps_per_execution=K)`` runs K steps a dispatch with no host
sync between them. On the card the port captures the step's gradient
computation once (:class:`StepGraph`) and replays it: a replay launches
the step's ~1,600 (LM) to ~2,900 (ResNet-50) kernels with one call, so
the host's per-launch cost leaves the step. The optimizer update stays
eager after each replay: the optimizers compute the learning rate and
Adam's bias corrections as host floats every step
(``optim.Adam._scalars``), which a graph would freeze at the captured
step, and the data-parallel gradient reduce and the fused Adam kernel
(K11) take the same host scalars.

Capture follows PyTorch's rules. The step first runs once eagerly on the
capture's side stream (lazy initialisation, the kernels' per-stream
workspaces of ``ops._build.workspace``, which are then allocated outside
the graph's pool and reused by the capture on the same stream); the
module's buffers (BatchNorm's running statistics) are put back after that
run, so it leaves no trace in the model. The capture then records the
step into a graph whose static inputs are copied in before each replay.
Kernels that keep arrival counters (K13/K14) return them to zero
themselves, so every replay starts clean. A capture that fails raises:
nothing falls back to the eager loop on the card.

Launch counts: a kernel's wrapper counts where it launches, which it
does in the warm-up and in the capture (into the graph). A replay runs
the graph's kernels without their wrappers and adds to no count; the
profiler's trace shows each kernel a replay runs, by name.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


class StepGraph:
    """``grad_eval(*inputs) -> (loss, grads, metric pairs)`` captured on the
    shapes and dtypes of ``inputs`` (CUDA tensors, or None for an input
    the step does not take: ``x``, ``y`` and the live loss scale of
    ``compile(precision="mixed_float16")``). :meth:`replay` copies new
    inputs into the static ones, replays, and returns the static outputs
    (overwritten by the next replay). The loss scale is such an input, a
    device tensor copied in before every replay: a host float would be
    frozen into the graph at its captured value."""

    def __init__(self, grad_eval: Callable, module: torch.nn.Module,
                 *inputs: Optional[torch.Tensor]):
        device = inputs[0].device
        self.inputs = [None if t is None else t.clone() for t in inputs]
        saved = [b.detach().clone() for b in module.buffers()]
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            grad_eval(*self.inputs)  # warm-up, eager
            with torch.no_grad():
                for b, v in zip(module.buffers(), saved):
                    b.copy_(v)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetch thread keeps staging batches (pinned
        # copies, event waits) while this thread captures.
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.outputs: Tuple = grad_eval(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)

    def replay(self, *inputs: Optional[torch.Tensor]) -> Tuple:
        for static, t in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(t)
        self.graph.replay()
        return self.outputs


__all__ = ["StepGraph"]
