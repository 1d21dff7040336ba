"""Continuous-batching serving engine over HHZS-tiered paged KV.

Request queue -> admission -> prefill -> interleaved decode with
continuous batching, in the reference's order.  The KV cache is paged and
two-tier (device / host) under the HHZS-style manager: preemption on
device-pool pressure *is* capacity migration, resumption *is* popularity
migration, and the prefix cache holds demoted sequences' first pages.

Attention runs through the port's kernels, picked by the device of their
tensors: on a CUDA engine the prefill calls the flash attention kernel
(causal over the prompt) and every decode step the paged attention kernel
over the sequence's pages through its block table; on a CPU engine both
take their plain versions.  The reference instead gathers each sequence's
pages and runs its dense ``sdpa``; both compute attention in fp32 (its
fp32 pool promotes K and V), and so does this engine.

Decode writes the new token's K/V into the pool before attending, layer
by layer, because the paged kernel reads only the pool: the slot is taken
with ``writable_zone`` before the first layer, and the write pointer and
byte counter advance once after the last, as ``write_token`` does.
Nothing calls the manager in between, so its calls, and every stat, come
in the reference's order.  A host-resident sequence decodes on the
device too: each layer's written pages are copied to a staging buffer on
the device with a block table of their own, and ``staged_bytes`` counts
that traffic.

Single stream, one request per decode launch (B = 1), as the reference
decodes one request at a time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..config import ModelConfig
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.paged_attention import ops as paged_ops
from ..models import layers as L
from ..models import model as M
from .paged_kv import PagedPool
from .tiering import HHZSKVManager, SeqKV


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # int32 tokens
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    state: str = "queued"            # queued | running | paused | done
    enqueued_step: int = 0

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.out_tokens)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[1, S, heads, D] -> [1, heads, S, D] fp32, contiguous."""
    return x.transpose(1, 2).float().contiguous()


class ServingEngine:
    """``model`` is a port ``models.Model``; it is moved to
    ``torch_device`` (in place, as ``nn.Module.to`` does), where the
    device KV pool lives too.  ``torch_device="cuda"`` raises when no card
    is visible."""

    def __init__(self, cfg: ModelConfig, model: M.Model, *,
                 hbm_zones: int = 8, host_zones: int = 64,
                 pages_per_zone: int = 4, page_size: int = 16,
                 max_batch: int = 4, cache_zones: int = 1,
                 torch_device="cuda"):
        if cfg.family != "dense":
            raise ValueError(f"{cfg.name}: the engine serves the dense "
                             f"family only, not {cfg.family!r}")
        dev = torch.device(torch_device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(torch_device='cuda'): no CUDA "
                               "card visible; pass torch_device='cpu' to "
                               "serve on the CPU")
        self.device = dev
        self.cfg = cfg
        self.model = model.to(dev)
        self.page_size = page_size
        mk = lambda name, zones, host: PagedPool(
            name, cfg.num_layers, zones, pages_per_zone, page_size,
            cfg.num_kv_heads, cfg.head_dim_, host=host, torch_device=dev)
        self.hbm = mk("hbm", hbm_zones, host=False)
        self.host = mk("host", host_zones, host=True)
        self.mgr = HHZSKVManager(self.hbm, self.host,
                                 cache_zones=cache_zones)
        self.max_batch = max_batch
        self.queue: List[Request] = []
        self.running: List[Request] = []
        self.done: List[Request] = []
        self.steps = 0
        self.tokens_out = 0
        self.staged_bytes = 0        # host-tier KV copied to the device

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.enqueued_step = self.steps
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _forward_tokens(self, req: Request, tokens: np.ndarray) -> int:
        """Run tokens through the model, appending KV to the paged store.
        Returns the argmax next token after the last position."""
        return int(torch.argmax(self._logits(req, tokens)))

    @torch.no_grad()
    def _logits(self, req: Request, tokens: np.ndarray) -> torch.Tensor:
        """Logits after the last of ``tokens``: the whole prompt of a new
        sequence, or one token of a running one."""
        cfg, model = self.cfg, self.model
        seq = self.mgr.seqs[req.rid]
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        x = model.embed[toks][None]                       # [1, T, d]
        if seq.length == 0:
            x = self._prefill(seq, x)
        elif len(toks) == 1:
            x = self._decode(seq, x)
        else:
            raise ValueError("after the prompt, tokens go one at a time")
        x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
        return L.matmul(x[0, -1], M.lm_head(cfg, model))

    def _qkv(self, layer, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        h = L.rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = L._project_qkv(layer.attn, cfg, h, h)
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)

    def _tail(self, layer, x: torch.Tensor, out: torch.Tensor):
        """Output projection, residual and MLP; ``out`` is the attention
        output [1, T, H * D] in fp32, so the residual stream turns fp32
        here, as the reference's does."""
        cfg = self.cfg
        x = x + L.matmul(out, layer.attn.wo)
        h = L.rms_norm(x, layer.mlp_norm, cfg.norm_eps)
        return x + L.mlp(layer.mlp, cfg, h)

    def _prefill(self, seq: SeqKV, x: torch.Tensor) -> torch.Tensor:
        """The prompt attends to itself causally (flash attention), then
        its KV is appended token by token: zone write pointers advance
        append-only, and a zone may fill or the sequence move tier
        between two tokens."""
        t_len = x.shape[1]
        positions = torch.arange(t_len, device=self.device)[None]
        ks, vs = [], []
        for layer in self.model.layers:
            q, k, v = self._qkv(layer, x, positions)
            ks.append(k[0])
            vs.append(v[0])
            out = flash_ops.flash_attention(_heads(q), _heads(k), _heads(v),
                                            causal=True)
            out = out.transpose(1, 2).reshape(1, t_len, -1)
            x = self._tail(layer, x, out)
        k_all, v_all = torch.stack(ks, 1), torch.stack(vs, 1)  # [T, L, KV, D]
        on_host = None
        for t in range(t_len):
            zone = self.mgr.writable_zone(seq)
            pool = self.mgr.pool_of(seq)
            if pool.host:
                if on_host is None:          # one copy for the prompt
                    on_host = (k_all.float().cpu().numpy(),
                               v_all.float().cpu().numpy())
                pool.write_token(zone, on_host[0][t], on_host[1][t])
            else:
                pool.write_token(zone, k_all[t], v_all[t])
            seq.length += 1
        return x

    def _decode(self, seq: SeqKV, x: torch.Tensor) -> torch.Tensor:
        """One token at position ``seq.length``, attending over the
        sequence's pages (itself included) with the paged kernel."""
        pos = seq.length
        zone = self.mgr.writable_zone(seq)   # may move this very sequence
        pool = self.mgr.pool_of(seq)
        page, slot = pool.next_slot(zone)
        n_pages = pos // self.page_size + 1
        pages = [pg for z in seq.zones for pg in z.pages][:n_pages]
        # the block table names pool pages, or the staging copy's 0..n-1
        table = list(range(len(pages))) if pool.host else pages
        table = torch.tensor([table], dtype=torch.int32, device=self.device)
        lens = torch.tensor([pos], dtype=torch.int32, device=self.device)
        positions = torch.full((1, 1), pos, device=self.device)
        for li, layer in enumerate(self.model.layers):
            q, k, v = self._qkv(layer, x, positions)
            pool.put(li, page, slot, k[0, 0], v[0, 0])
            if pool.host:
                kp, vp = self._stage(pool.k[li], pages), \
                    self._stage(pool.v[li], pages)
            else:
                kp, vp = pool.k[li], pool.v[li]
            out = paged_ops.paged_attention(q[0].float().contiguous(), kp,
                                            vp, table, lens)
            x = self._tail(layer, x, out.reshape(1, 1, -1))
        pool.advance(zone)
        seq.length += 1
        return x

    def _stage(self, host_layer: np.ndarray, pages: List[int]):
        """A host-resident sequence's pages of one layer, copied to the
        engine's device: [len(pages), page_size, KV, D]."""
        staged = torch.from_numpy(host_layer[pages]).to(self.device)
        self.staged_bytes += staged.numel() * staged.element_size()
        return staged

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration: admit, prefill one, decode all running."""
        self.steps += 1
        # admission
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue.pop(0)
            self.mgr.on_prefill(req.rid, len(req.prompt))
            nxt = self._forward_tokens(req, req.prompt)
            req.out_tokens.append(nxt)
            req.state = "running"
            self.running.append(req)
            self.tokens_out += 1
        # migration tick with the active set
        self.mgr.tick([r.rid for r in self.running])
        # decode one token for every running sequence
        for req in list(self.running):
            nxt = self._forward_tokens(
                req, np.asarray([req.out_tokens[-1]], np.int32))
            req.out_tokens.append(nxt)
            self.tokens_out += 1
            if len(req.out_tokens) >= req.max_new_tokens:
                req.state = "done"
                self.running.remove(req)
                self.done.append(req)
                self.mgr.release(req.rid)

    def run(self, max_steps: int = 100) -> Dict:
        while (self.queue or self.running) and self.steps < max_steps:
            self.step()
        st = dict(self.mgr.stats)
        st.update(steps=self.steps, tokens_out=self.tokens_out,
                  done=len(self.done),
                  hbm_free_zones=self.hbm.num_free(),
                  host_free_zones=self.host.num_free())
        return st
