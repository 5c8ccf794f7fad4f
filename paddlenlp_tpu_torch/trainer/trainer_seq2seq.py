"""``Seq2SeqTrainer``: evaluation through ``model.generate``.

PyTorch port of ``paddlenlp_tpu/trainer/trainer_seq2seq.py`` for the port's
decoder-only models: ``evaluate`` with ``predict_with_generate`` runs
:meth:`Seq2SeqTrainer.generate_and_score`, which left-repacks each eval batch
(eval collators right-pad; batched decoder prompts need left padding),
generates with ``gen_kwargs`` and hands the token sequences to
``compute_metrics``. The encoder-decoder branches (the teacher-forced loss
and eval step of T5/BART) wait for those families: ROADMAP Queue 1 item 14e.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .trainer import Trainer
from .trainer_utils import EvalPrediction, PredictionOutput, speed_metrics

__all__ = ["Seq2SeqTrainer"]

_ENCDEC = "encoder-decoder models (ROADMAP Queue 1 item 14e, the T5 and BART families)"


def _left_repack(ids: np.ndarray, mask: np.ndarray):
    """Move each row's valid tokens to the right edge (left padding)."""
    out_ids = np.zeros_like(ids)
    out_mask = np.zeros_like(mask)
    for i in range(len(ids)):
        valid = ids[i][mask[i] == 1]
        if len(valid):
            out_ids[i, -len(valid):] = valid
            out_mask[i, -len(valid):] = 1
    return out_ids, out_mask


class Seq2SeqTrainer(Trainer):
    def __init__(self, *args, gen_kwargs: Optional[dict] = None, predict_with_generate: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.gen_kwargs = gen_kwargs or {"max_new_tokens": 64, "do_sample": False}
        self.predict_with_generate = predict_with_generate

    def _encoder_decoder(self) -> bool:
        return bool(getattr(self.model.config, "is_encoder_decoder", False))

    def compute_loss(self, inputs, params=None):
        if self._encoder_decoder():
            raise NotImplementedError(f"Seq2SeqTrainer.compute_loss: {_ENCDEC} are not part of the port yet")
        return super().compute_loss(inputs, params)

    def _eval_step(self, host_batch):
        if self._encoder_decoder():
            raise NotImplementedError(f"Seq2SeqTrainer's teacher-forced eval step: {_ENCDEC} are not part of "
                                      "the port yet")
        return super()._eval_step(host_batch)

    def generate_and_score(self, test_dataset, metric_key_prefix: str = "test") -> PredictionOutput:
        """Batch generate over the dataset; ``compute_metrics`` sees token
        sequences (one numpy row a sample)."""
        if self._encoder_decoder():
            raise NotImplementedError(f"Seq2SeqTrainer.generate_and_score: {_ENCDEC} are not part of the port yet")
        start = time.time()
        dataloader = self.get_eval_dataloader(test_dataset)
        preds: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for host_batch in dataloader:
            ids = np.asarray(host_batch["input_ids"])
            mask = np.asarray(host_batch.get("attention_mask", np.ones_like(ids)))
            ids, mask = _left_repack(ids, mask)
            out, _ = self.model.generate(ids, attention_mask=mask, **self.gen_kwargs)
            preds.extend(out.cpu().numpy())
            if "labels" in host_batch:
                labels.extend(np.asarray(host_batch["labels"]))
        metrics: Dict[str, float] = {}
        if self.compute_metrics is not None:
            metrics = {
                f"{metric_key_prefix}_{k}": v
                for k, v in self.compute_metrics(EvalPrediction(predictions=preds, label_ids=labels or None)).items()
            }
        metrics.update(speed_metrics(metric_key_prefix, start, num_samples=len(preds)))
        return PredictionOutput(predictions=preds, label_ids=labels or None, metrics=metrics)

    def evaluate(self, eval_dataset=None, ignore_keys=None, metric_key_prefix: str = "eval"):
        if self.predict_with_generate:
            dataset = eval_dataset if eval_dataset is not None else self.eval_dataset
            out = self.generate_and_score(dataset, metric_key_prefix)
            self.state.log_history.append(dict(out.metrics))
            return out.metrics
        return super().evaluate(eval_dataset, ignore_keys, metric_key_prefix)
