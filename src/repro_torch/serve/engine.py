"""Serial serving engine: prefill + greedy decode of one batch end to end.
Port of `repro/serve/engine.py` (the reference's channel front door
re-export is not ported: front ends come later).

`ServeEngine` is the serial baseline the continuous-batching scheduler is
measured against. Its execution units are dispatched through the compute
manager of a registry-built `Runtime`, so the engine never imports a
concrete backend. The whole batch decodes at one shared position, so the
decode step takes a scalar `pos`; the dense caches are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.runtime import Runtime
from repro_torch.models.model_zoo import ModelBundle


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, steps) int32
    prefill_logits: np.ndarray  # (B, V) float32


class ServeEngine:
    def __init__(
        self,
        model: ModelBundle,
        params,
        *,
        max_len: int = 256,
        runtime: Optional[Runtime] = None,
    ):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.rt = runtime or Runtime("torchdev")
        #: device of the runtime's processing unit: every unit's tensors live here
        self.device: torch.device = self.rt.processing_unit.context
        emb = params["embed"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, the runtime on {self.device}")
        cm = self.rt.compute_manager
        # prefill allocates cache headroom up to max_len so decode steps
        # never write past the cache
        prefill_fn = model.make_prefill(max_len)
        self._prefill_unit = cm.create_execution_unit(prefill_fn, name="prefill")
        self._decode_unit = cm.create_execution_unit(model.decode_step, name="decode_step")

    def generate(self, prompts: np.ndarray, steps: int, *, on_first_token=None) -> GenerationResult:
        """prompts: (B, S) int32. Greedy decode `steps` new tokens.
        `on_first_token`, if given, is called once the first output token is
        on the host (prefill done): a TTFT probe."""
        prompts = np.asarray(prompts, dtype=np.int32)
        B, S = prompts.shape
        if S + steps > self.max_len:  # the last decode step writes position S + steps - 1
            raise ValueError(f"{S} prompt tokens + {steps} steps exceed max_len {self.max_len}")
        tokens = torch.as_tensor(prompts, device=self.device)
        logits, state = self.rt.run(self._prefill_unit, self.params, {"tokens": tokens})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [tok[:, 0].cpu().numpy()]  # the first token, on the host
        if on_first_token is not None:
            on_first_token()
        pos = S
        # as the reference: `steps` decode steps, the last one's token unused
        for _ in range(steps):
            dlogits, state = self.rt.run(
                self._decode_unit, self.params, state, {"tokens": tok, "pos": pos}
            )
            tok = torch.argmax(dlogits, dim=-1).to(torch.int32)[:, None]
            out.append(tok[:, 0].cpu().numpy())
            pos += 1
        return GenerationResult(
            tokens=np.stack(out[:steps], axis=1), prefill_logits=logits.float().cpu().numpy()
        )
