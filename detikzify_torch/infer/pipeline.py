"""User-facing inference pipeline (counterpart of
``detikzify_tpu/infer/pipeline.py``).

``sample()`` generates one TikZ program for one figure; ``sample_batch()``
runs many figures' rollouts concurrently over the engine's slots with one
vision pass for the batch; ``simulate()`` refines with MCTS and yields
(score, TikzDocument) per rollout. Default hyperparameters are the
reference's (T=0.8, top-p 0.95, top-k 0; compile timeout 60 s; exploration
0.6). One ``DecodeEngine`` (page pool + sampling state) is shared across
calls; ``speculate=K`` makes it a speculative engine (n-gram drafts of K
tokens, verified on kernel K4). ``metric="model"`` (the default) scores
with SelfSim on the model's own vision tower (``evaluate.ImageSim``, EMD
for v2); ``metric="fast"`` with compiler diagnostics only. With
``adapter=`` (the TikZero adapter's ``AdapterBundle``) ``sample()`` and
``simulate()`` take a caption (``text``), with a figure or alone, and
SelfSim scores each render against the caption-conditioned features of
the input.
"""
from __future__ import annotations

from typing import Generator, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from ..config import DetikzifyConfig
from ..engine import DecodeEngine
from ..evaluate.imagesim import ImageSim
from ..models.detikzify import Params
from ..ops.sampling import SamplingParams
from ..processing import DetikzifyProcessor
from ..utils.image import expand, load
from .generator import DetikzifyGenerator
from .tikz import CompileService, TikzDocument

Numeric = Union[int, float]


class DetikzifyPipeline:
    def __init__(
        self,
        params: Params,
        cfg: DetikzifyConfig,
        processor: DetikzifyProcessor,
        *,
        temperature: float = 0.8,
        top_p: float = 0.95,
        top_k: int = 0,
        compile_timeout: float = 60.0,
        metric: Union[str, object] = "model",
        num_slots: int = 8,
        max_len: Optional[int] = None,
        exploration: float = 0.6,
        compile_workers: int = 4,
        speculate: int = 0,                # n-gram speculative decoding
        engine: Optional[DecodeEngine] = None,
        adapter=None,                      # AdapterBundle (TikZero)
        device="cuda",
        seed: int = 0,
    ):
        self.cfg = cfg
        self.processor = processor
        self.compile_timeout = compile_timeout
        self.exploration = exploration
        self.adapter = adapter
        self.engine = engine or DecodeEngine(
            params, cfg, num_slots=num_slots,
            max_len=max_len or min(processor.model_max_length,
                                   cfg.model_max_length),
            speculate=speculate,
            sampling=SamplingParams(temperature=temperature, top_p=top_p,
                                    top_k=top_k),
            device=device, seed=seed)
        if metric == "model":   # SelfSim on the model's own vision tower
            self.metric = ImageSim.from_detikzify(params, cfg,
                                                  processor=processor,
                                                  adapter=adapter)
        elif metric == "fast":  # compiler diagnostics only
            self.metric = None
        else:
            self.metric = metric
        self.compiler = CompileService(workers=compile_workers,
                                       timeout=compile_timeout)

    # ------------------------------------------------------------------

    def load(self, image: Union[Image.Image, str], preprocess: bool = True
             ) -> Image.Image:
        image = load(image)
        if preprocess:
            return expand(image, max(image.size), do_trim=True)
        return image

    def check_inputs(self, image, text) -> None:
        if text is not None and self.adapter is None:
            raise ValueError(
                "You need to load an adapter for textual inputs!")
        if image is None and text is None:
            raise ValueError("Either image or text (or both) required!")

    def _sampling_override(self, temperature, top_p, top_k):
        """Merge per-call sampling kwargs over the pipeline defaults."""
        if temperature is None and top_p is None and top_k is None:
            return None
        base = self.engine.sampling
        return base._replace(
            **{k: v for k, v in [("temperature", temperature),
                                 ("top_p", top_p), ("top_k", top_k)]
               if v is not None})

    def _generator(self, image, text, preprocess, *, metric=None,
                   mcts_timeout=None, control=None, on_token=None,
                   temperature=None, top_p=None, top_k=None,
                   exploration=None, compile_timeout=None,
                   **kw) -> DetikzifyGenerator:
        self.check_inputs(image, text)
        return DetikzifyGenerator(
            sampling=self._sampling_override(temperature, top_p, top_k),
            engine=self.engine,
            processor=self.processor,
            image=self.load(image, preprocess) if image is not None else None,
            text=text,
            metric=metric,
            compile_timeout=self.compile_timeout
            if compile_timeout is None else compile_timeout,
            mcts_timeout=mcts_timeout,
            exploration=self.exploration if exploration is None
            else exploration,
            compile_service=self.compiler,
            control=control,
            on_token=on_token,
            adapter=self.adapter,
            **kw,
        )

    def generator(self, image: Optional[Union[Image.Image, str]] = None,
                  text: Optional[str] = None, preprocess: bool = True,
                  **kw) -> DetikzifyGenerator:
        """A ``DetikzifyGenerator`` bound to this pipeline's engine, not
        driven; the caller must ``close()`` it."""
        return self._generator(image, text, preprocess, **kw)

    def sample(self, image: Optional[Union[Image.Image, str]] = None,
               text: Optional[str] = None, preprocess: bool = True,
               **kw) -> TikzDocument:
        """DeTikZify a raster image, a caption, or both: sample a single
        TikZ program."""
        gen = self._generator(image, text, preprocess, **kw)
        try:
            return gen.sample()
        finally:
            gen.close()

    def sample_batch(self, images: list, preprocess: bool = True,
                     max_new_tokens: Optional[int] = None,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None,
                     top_k: Optional[int] = None) -> list:
        """One-shot sampling for a mini-batch of figures: one vision pass
        for the batch, every rollout continuous-batched over the slots."""
        pil = [self.load(img, preprocess) for img in images]
        out = self.processor(images=pil)
        embeds = self.engine.encode_image(out.pixel_values)
        # `is not None`: max_new_tokens=0 means zero new tokens, as on the
        # singleton sample() path
        max_new = (max_new_tokens if max_new_tokens is not None
                   else self.engine.max_len - 1 - out.input_ids.shape[1])

        queue = list(range(len(pil)))
        rollouts: dict = {}
        generated: dict = {}
        sampling = self._sampling_override(temperature, top_p, top_k)
        while queue or rollouts:
            n = min(self.engine.num_free_slots, len(queue))
            if n > 0:
                # burst-start one figure wave as fused starts
                wave = [queue.pop(0) for _ in range(n)]
                idx = torch.as_tensor(np.asarray(wave), device=embeds.device)
                ros = self.engine.start_many(
                    [[int(t) for t in out.input_ids[i]] for i in wave],
                    image_embeds=embeds[idx],
                    max_new_tokens=max_new, sampling=sampling)
                rollouts.update(dict(zip(wave, ros)))
            self.engine.step()
            # release each rollout AS IT FINISHES, so a shared engine's
            # other users get the slot back
            for i, ro in list(rollouts.items()):
                if ro.finished:
                    generated[i] = list(ro.token_ids[ro.prompt_len:])
                    self.engine.release(ro)
                    del rollouts[i]

        docs = []
        for i in range(len(pil)):
            code = self.processor.decode(generated[i],
                                         skip_special_tokens=True)
            docs.append(TikzDocument(code, timeout=self.compile_timeout,
                                     backend=self.compiler.backend))
        return docs

    def simulate(
        self,
        image: Optional[Union[Image.Image, str]] = None,
        text: Optional[str] = None,
        preprocess: bool = True,
        expansions: Optional[Numeric] = None,
        timeout: Optional[Numeric] = None,
        parallelism: int = 1,
        **kw,
    ) -> Generator[Tuple[Numeric, TikzDocument], None, None]:
        """DeTikZify with MCTS refinement: yields (score, doc) per rollout.
        ``parallelism > 1`` runs that many expansions at once on the
        engine's slots."""
        gen = self._generator(image, text, preprocess, metric=self.metric,
                              mcts_timeout=timeout or None, **kw)
        try:
            yield from gen.simulate(expansions or None,
                                    parallelism=parallelism)
        finally:
            gen.close()

    def close(self) -> None:
        self.compiler.shutdown()

    def __call__(self, *args, **kw) -> TikzDocument:
        return self.sample(*args, **kw)
