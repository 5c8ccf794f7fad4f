"""PPO trainer: policy, reference, reward and (optionally) value models.

Port of ``paddlenlp_tpu/trl/ppo_trainer.py``:

- each round rolls out through the port's paged ``InferenceEngine`` (fp32,
  the prefix cache off: its content-addressed blocks are valid only under
  frozen weights), one engine for every round; the engine reads the policy's
  parameter tensors, which the optimizer updates in place, so each round
  samples from the current policy with no weight copy or re-bind;
- the update is the token-level clipped-surrogate objective with an entropy
  bonus; two baselines: group-relative advantages (GRPO, no value model, the
  default, with the KL penalty in the loss) or a jointly trained value model
  with GAE (``use_value_model``: the per-token KL penalty folded into the
  rewards, the score at the last response token, a clipped value loss).

The JAX package falls back to ``model.generate`` for an unrolled layout; the
port's models are always stacked, so its rollouts always take the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..experimental import InferenceEngine, SamplingParams
from ..ops.optimizer import AdamW, global_norm
from ..transformers.conversion_utils import flatten_params, unflatten_params
from ..utils.log import logger
from ..trainer.trainer import Trainer
from ..trainer.trainer_utils import TrainOutput, copy_aliased_params
from .dpo_criterion import token_logps

__all__ = ["PPOTrainer", "PPOConfig", "token_logps", "gae_advantages"]


@dataclasses.dataclass
class PPOConfig:
    num_rollouts_per_prompt: int = 4  # the "group" for the group-relative baseline
    max_new_tokens: int = 32
    max_prompt_length: int = 512  # prompts are truncated to this; sizes the KV pool
    temperature: float = 1.0
    top_p: float = 1.0
    clip_ratio: float = 0.2
    kl_coef: float = 0.05
    ppo_epochs: int = 1
    normalize_advantages: bool = True
    entropy_coef: float = 0.0
    # value-model (reference quartet) mode
    use_value_model: bool = False
    gamma: float = 1.0
    gae_lambda: float = 0.95
    value_clip: float = 0.2
    vf_coef: float = 0.5
    value_lr: float = 1e-5


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, gamma: float,
                   lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over right-padded token rows
    (rewards, values, mask [B, T]), walking time backwards so the last valid
    token sees a next value of 0. Returns (advantages, returns), zero outside
    the mask."""
    B, T = rewards.shape
    m = mask.bool()
    adv_next = torch.zeros(B, dtype=torch.float32, device=rewards.device)
    v_next = torch.zeros_like(adv_next)
    adv = torch.zeros(B, T, dtype=torch.float32, device=rewards.device)
    for t in range(T - 1, -1, -1):
        delta = rewards[:, t] + gamma * v_next - values[:, t]
        a = delta + gamma * lam * adv_next
        adv_next = torch.where(m[:, t], a, adv_next)
        v_next = torch.where(m[:, t], values[:, t], v_next)
        adv[:, t] = torch.where(m[:, t], a, torch.zeros_like(a))
    return adv, torch.where(m, adv + values, torch.zeros_like(adv))


class PPOTrainer(Trainer):
    """``train_dataset`` yields ``{"input_ids": prompt}``; ``reward_fn`` or a
    ``reward_model`` (a sequence classifier) scores whole sequences. Each
    trainer step is one rollout round and ``ppo_epochs`` updates."""

    def __init__(self, model=None, ref_model=None, reward_model=None,
                 reward_fn: Optional[Callable[[np.ndarray, np.ndarray], float]] = None, value_model=None,
                 ppo_config: Optional[PPOConfig] = None, **kwargs):
        super().__init__(model=model, **kwargs)
        self.ppo_config = ppo_config or PPOConfig()
        if reward_model is None and reward_fn is None:
            raise ValueError("PPOTrainer needs reward_model or reward_fn")
        self.reward_model = reward_model
        self.reward_fn = reward_fn
        self.ref_params = copy_aliased_params(ref_model.params if ref_model is not None else model.params,
                                              model.params)
        c = self.ppo_config
        per_seq = (c.max_new_tokens + c.max_prompt_length) // 16 + 2
        rows = self.args.per_device_train_batch_size * c.num_rollouts_per_prompt
        self._engine_kwargs = dict(max_batch_size=rows, block_size=16, num_blocks=max(512, 4 * per_seq * rows),
                                   max_blocks_per_seq=256, enable_prefix_cache=False)
        self._engine = None
        if c.use_value_model:
            self._init_value_model(value_model)

    # ------------------------------------------------------------------ value model
    def _init_value_model(self, value_model):
        """The value model: a copy of the policy's (or ``value_model``'s)
        trunk and a scalar head N(0, 0.01^2) drawn from seed 7, trained by
        optax's ``adamw(value_lr)`` defaults (weight decay 1e-4 on every
        leaf, no clip)."""
        src = value_model if value_model is not None else self.model
        self._value_backbone = src
        gen = torch.Generator(device=src.device).manual_seed(7)
        head = torch.empty(src.config.hidden_size, 1, dtype=torch.float32, device=src.device).normal_(
            0.0, 0.01, generator=gen)
        self.value_params = {"model": unflatten_params({k: v.detach().clone() for k, v in
                                                        flatten_params(src.params["model"]).items()}),
                             "value_head": {"kernel": head}}
        self._value_opt = AdamW(flatten_params(self.value_params), self.ppo_config.value_lr, weight_decay=1e-4,
                                decays=lambda name: True)

    def _values(self, vparams, ids, mask):
        h = self._value_backbone.hidden_states(ids, params=vparams, attention_mask=mask)
        return (h.float() @ vparams["value_head"]["kernel"])[..., 0]

    def _value_update(self, batch, old_values, returns, valid) -> torch.Tensor:
        c = self.ppo_config
        params = flatten_params(self.value_params)
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        v = self._values(self.value_params, batch["input_ids"][:, :-1], batch["attention_mask"][:, :-1])
        v_clip = old_values + torch.clamp(v - old_values, -c.value_clip, c.value_clip)
        per_tok = torch.maximum(torch.square(v - returns), torch.square(v_clip - returns))
        denom = torch.clamp(valid.sum(), min=1)
        loss = c.vf_coef * 0.5 * torch.where(valid, per_tok, torch.zeros_like(per_tok)).sum() / denom
        loss.backward()
        self._value_opt.step(params, {k: p.grad for k, p in params.items()})
        for p in params.values():
            p.grad = None
            p.requires_grad_(False)
        return loss.detach()

    # ------------------------------------------------------------------ rollout
    def rollout(self, prompts: List[np.ndarray]) -> Dict[str, np.ndarray]:
        """Sample ``num_rollouts_per_prompt`` responses a prompt through the
        engine (request i seeded ``global_step * 9973 + i``); right-pad them
        into one batch whose labels mask the prompts."""
        c = self.ppo_config
        reqs = []
        for p in prompts:
            p = p[-c.max_prompt_length:]
            for _ in range(c.num_rollouts_per_prompt):
                reqs.append((p, SamplingParams(max_new_tokens=c.max_new_tokens, do_sample=True,
                                               temperature=c.temperature, top_p=c.top_p,
                                               seed=int(self.state.global_step * 9973 + len(reqs)))))
        if self._engine is None:
            self._engine = InferenceEngine(self.model, eos_token_id=self.model.config.eos_token_id,
                                           dtype=torch.float32, **self._engine_kwargs)
        engine = self._engine
        ids = [engine.add_request(p, s) for p, s in reqs]
        results = {}
        while engine.has_work():
            for r in engine.step():
                results[r.req_id] = r.output_ids
        outs = [results[i] for i in ids]

        rows = [np.concatenate([p, np.asarray(o, np.int32)]) for (p, _), o in zip(reqs, outs)]
        labels = [np.concatenate([np.full(len(p), -100, np.int32), np.asarray(o, np.int32)])
                  for (p, _), o in zip(reqs, outs)]
        max_len = max(len(r) for r in rows)
        ids_arr = np.zeros((len(rows), max_len), np.int32)
        lab_arr = np.full((len(rows), max_len), -100, np.int32)
        mask_arr = np.zeros((len(rows), max_len), np.int32)
        for i, (r, lab) in enumerate(zip(rows, labels)):
            ids_arr[i, :len(r)] = r
            lab_arr[i, :len(lab)] = lab
            mask_arr[i, :len(r)] = 1
        return {"input_ids": ids_arr, "labels": lab_arr, "attention_mask": mask_arr}

    def _score(self, ids: np.ndarray, labels: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        if self.reward_fn is not None:
            return np.asarray([self.reward_fn(ids[i], labels[i]) for i in range(len(ids))], np.float32)
        # the mask is required: the classifier pools at each row's last valid token
        dev = self.reward_model.device
        logits = self.reward_model(torch.as_tensor(ids, device=dev),
                                   attention_mask=torch.as_tensor(attention_mask, device=dev))
        return logits[..., 0].float().cpu().numpy().reshape(-1)

    # ------------------------------------------------------------------ update
    def _ppo_update(self, batch, old_logps, ref_logps, advantages) -> Dict[str, torch.Tensor]:
        """One optimizer update of the token-level clipped surrogate;
        ``advantages`` [B, T-1]."""
        c = self.ppo_config
        params = self.trainable_params
        for k, p in self.params.items():
            p.requires_grad_(k in params)
            p.grad = None
        logits = self.model.forward(batch["input_ids"][:, :-1], attention_mask=batch["attention_mask"][:, :-1])
        logps, valid = token_logps(logits, batch["labels"][:, 1:])
        denom = torch.clamp(valid.sum(), min=1)
        zero = torch.zeros_like(logps)
        ratio = torch.exp(logps - old_logps)
        unclipped = ratio * advantages
        clipped = torch.clamp(ratio, 1 - c.clip_ratio, 1 + c.clip_ratio) * advantages
        loss = -torch.where(valid, torch.minimum(unclipped, clipped), zero).sum() / denom
        if not c.use_value_model:  # the GRPO KL penalty; the value-model mode folds it into the rewards
            loss = loss + c.kl_coef * torch.where(valid, logps - ref_logps, zero).sum() / denom
        if c.entropy_coef:
            p = torch.softmax(logits.float(), dim=-1)
            ent = -(p * torch.log(torch.clamp(p, min=1e-9))).sum(-1)
            loss = loss - c.entropy_coef * torch.where(valid, ent, zero).sum() / denom
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        grad_norm = global_norm(grads.values())
        self.optimizer.step(params, grads, grad_norm)
        for p in params.values():
            p.grad = None
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def train(self, resume_from_checkpoint=None, **kwargs):
        """The rollout and update loop (it replaces the token-level loop)."""
        args, c = self.args, self.ppo_config
        max_steps = args.max_steps if args.max_steps > 0 else 10
        self.create_optimizer_and_scheduler(max_steps)
        self.state.max_steps = max_steps
        prompts_iter = self._prompt_iterator()
        last_loss, rewards = float("nan"), np.zeros(1, np.float32)
        for _ in range(max_steps):
            prompts = [next(prompts_iter) for _ in range(args.per_device_train_batch_size)]
            batch = self.rollout(prompts)
            rewards = self._score(batch["input_ids"], batch["labels"], batch["attention_mask"])
            dev = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            ids, mask, labels = dev["input_ids"][:, :-1], dev["attention_mask"][:, :-1], dev["labels"][:, 1:]
            # old and reference log-probs once a round (they hold across epochs)
            with torch.no_grad():
                old_logps, valid = token_logps(self.model.forward(ids, attention_mask=mask), labels)
                ref_logps = token_logps(self.model.forward(ids, params=self.ref_params, attention_mask=mask),
                                        labels)[0]
                validf = valid.float()
                if c.use_value_model:
                    old_values = self._values(self.value_params, ids, mask)
                    # the KL penalty on every token, the score at the last response token
                    rev_cum = torch.flip(torch.cumsum(torch.flip(validf, [1]), dim=1), [1])
                    is_last = valid & (rev_cum == 1)
                    tok_rewards = -c.kl_coef * (old_logps - ref_logps) * validf
                    tok_rewards = tok_rewards + is_last * torch.as_tensor(rewards, device=self.device)[:, None]
                    adv, returns = gae_advantages(tok_rewards, old_values * validf, validf, c.gamma, c.gae_lambda)
                else:
                    grouped = rewards.reshape(-1, c.num_rollouts_per_prompt)
                    # the group-relative (GRPO) baseline, over the response tokens
                    seq_adv = (grouped - grouped.mean(-1, keepdims=True)).reshape(-1)
                    adv = torch.as_tensor(seq_adv, device=self.device)[:, None] * valid
                    returns = old_values = None
                if c.normalize_advantages:
                    n = torch.clamp(validf.sum(), min=1)
                    mean = (adv * validf).sum() / n
                    var = (torch.square(adv - mean) * validf).sum() / n
                    adv = torch.where(valid, (adv - mean) / torch.sqrt(var + 1e-8), torch.zeros_like(adv))
            for _ in range(c.ppo_epochs):
                metrics = self._ppo_update(dev, old_logps, ref_logps, adv)
                if c.use_value_model:
                    vloss = self._value_update(dev, old_values, returns, valid)
            last_loss = float(metrics["loss"])
            self.state.global_step += 1
            msg = (f"ppo step {self.state.global_step}/{max_steps}: "
                   f"reward_mean={rewards.mean():.4f} loss={last_loss:.4f}")
            if c.use_value_model:
                msg += f" value_loss={float(vloss):.4f}"
            logger.info(msg)
        return TrainOutput(self.state.global_step, last_loss, {"reward_mean": float(rewards.mean())})

    def _prompt_iterator(self):
        while True:
            for i in range(len(self.train_dataset)):
                yield np.asarray(self.train_dataset[i]["input_ids"], np.int32)
