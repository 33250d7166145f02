"""Teacher-forced losses for the talker and the residual-code predictor
(the JAX package's training/loss.py).

Batch layout (tensors on the parameters' device; ``train.device_batch``
moves a host batch there):

    text_tokens  [B, T_text]  int, right-padded with ``pad_id``
    text_mask    [B, T_text]  bool  (True = real token)
    codes        [B, Q, T_f]  int   ground-truth codec codes
    frame_mask   [B, T_f]     bool  (True = real frame)
    speaker_id   [B]          int   (optional; -1 = unconditioned row)

The talker consumes [text embeddings][BOS][codec-0 embeddings of frames
0..T_f-2] and predicts codec-0 ids for frames 0..T_f-1 (next-token CE at the
frame positions). The code predictor consumes (talker hidden at each frame,
ground-truth codebook-0) and predicts residual books 1..Q-1 with
teacher-forced depth inputs.

``remat=True`` recomputes each transformer block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations. Both settings run the blocks through ``layers.run_blocks``,
where every block allocates its own zero KV cache inside the
(checkpointed) block function, so a recompute writes fresh buffers. The
two give equal values.

Training across ranks (``joint_loss``'s keywords): ``mesh`` is this rank's
place (``parallel.mesh``): the talker's blocks are its tp shard, and the
batch its dp rows, over which every masked mean is the JAX package's
global one (the masked sum of this rank's rows over the mask count summed
over dp: the rank's share of the loss, summed over dp by the train
step). The JAX hooks are ``stack_fn`` (the pipelined block stack,
``parallel.pipeline.talker_stack_fn``: the loss then runs on the last
stage, and returns None on the others) and ``sequence_parallel`` (the
port's form of ``act_constraint``: the residual stream between blocks is
this rank's T slice, padded at the end to a multiple of tp).
"""

from __future__ import annotations

from typing import Any

import torch

from ..engine.configs import ModelConfig
from ..models.code_predictor import residual_feedback_sum
from ..models.layers import rmsnorm, rope_tables, run_blocks
from ..models.talker import (
    merge_step_embs,
    merge_step_tokens,
    mtp_logits,
    mtp_logits_emb,
    text_projection,
)
from ..ops.linear import linear
from ..parallel.comm import enter_seq, exit_seq, sum_


def _count(m: torch.Tensor, mesh) -> torch.Tensor:
    """The mask count, summed over dp under a mesh with dp > 1."""
    count = torch.sum(m)
    if mesh is not None and mesh.plan.dp > 1:
        count = sum_(count.detach().clone(), mesh.dp_group, mesh, "dp_sum")
    return torch.clamp(count, min=1.0)


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Masked mean CE. logits [..., V], targets [...] int, mask bool. Under
    a dp mesh: this rank's masked sum over the global count."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    m = mask.float()
    return torch.sum(nll * m) / _count(m, mesh)


def _talker_stack(params: Any, t, x: torch.Tensor, pad_len, remat: bool,
                  hooks: dict | None = None):
    """(hidden, logits f32) of a full-sequence talker pass from position
    0: ``talker_forward``'s computation over ``layers.run_blocks``, or
    (None, None) on a pipeline stage other than the last. ``hooks``:
    ``stack_fn``, ``mesh`` and ``sequence_parallel`` (module docstring)."""
    hooks = hooks or {}
    mesh, sp = hooks.get("mesh"), hooks.get("sequence_parallel", False)
    if hooks.get("stack_fn") is not None:
        y = hooks["stack_fn"](params["blocks"], x, pad_len)
        if y is None:
            return None, None
    else:
        xs = enter_seq(x, mesh) if sp else x
        cos_t, sin_t = rope_tables(xs.shape[1] * (mesh.tp if sp else 1),
                                   t.head_dim, t.rope_theta, x.device)
        y = run_blocks(params["blocks"], xs, cos=cos_t, sin=sin_t,
                       n_heads=t.n_heads, n_kv_heads=t.n_kv_heads,
                       head_dim=t.head_dim, rms_eps=t.rms_eps, qk_norm=True,
                       pad_len=pad_len, remat=remat, mesh=mesh, sp=sp)
        if sp:
            y = exit_seq(y, mesh, x.shape[1])
    hidden = rmsnorm(y, params["ln_f"], t.rms_eps)
    return hidden, linear(hidden, params["head"]).float()


def _published_hidden_and_logits(
    params: Any, cp_params: Any, cfg: ModelConfig, batch: dict,
    remat: bool = False, hooks: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward under the published decode protocol
    (TalkerConfig.feedback="residual_sum"), the inference layout of
    runtime/generate.py's published prompt and feedback decode loop:

        txt[0..2] | tts_pad+[markers] | (tts_pad+speaker)? |
        tts_bos+codec_pad | txt[3]+codec_bos |
        frame g: codec_emb[cb0_g] + sum_d res_emb[d][code_{d+1,g}] + trail(g)

    where trail(g) is the projected text row n_head+1+g, then tts_eos, then
    tts_pad (the talker re-reads the text one token per frame). Residual
    sums are teacher-forced from ground-truth codes.

    ``frames_per_step > 1`` mirrors the MTP decode chain: each step's
    talker input is the learned merge of its fps frames' full feedback
    embeddings; frame 0 of a step scores through the main head, frames
    1..fps-1 through the embedding-conditioned MTP chain, teacher-forced
    on the previous frame's cb0 + residual-sum embedding (its cb0
    embedding alone under ``mtp_cp_batch``), without the trailing row.
    Returned hiddens interleave [step hidden, chain hiddens], the hidden
    that conditions each frame's code-predictor pass in decode."""
    t = cfg.talker
    fps = t.frames_per_step
    text = batch["text_tokens"]                       # [B, Tt] right-padded
    text_mask = batch["text_mask"]
    codes = batch["codes"]                            # [B, Q, Tf]
    codes0 = codes[:, 0, :]
    B, Tt = text.shape
    Tf = codes0.shape[1]
    dev = text.device
    assert Tf % fps == 0, (
        f"frames {Tf} must be a multiple of frames_per_step {fps}"
    )

    txt = text_projection(params, params["text_emb"][text])   # [B, Tt, D]
    ctl = torch.tensor([t.tts_pad_id, t.tts_bos_id, t.tts_eos_id],
                       device=dev)
    ctl_e = text_projection(params, params["text_emb"][ctl])
    pad_e, bos_e, eos_e = ctl_e[0], ctl_e[1], ctl_e[2]
    # static 3-row chatml head: every example must carry >=4 real text
    # tokens (training/data.py rejects shorter examples before batching)
    assert Tt >= 4, f"text bucket too short for the published head ({Tt})"
    n_head = 3
    D = txt.shape[-1]

    def brow(row):                                    # [D] -> [B, 1, D]
        return row[None, None, :].expand(B, 1, D)

    codec_emb = params["codec_emb"]
    parts = [txt[:, :n_head]]
    for tok in t.codec_prompt_head:
        parts.append(brow(pad_e + codec_emb[tok]))
    if "speaker_token" in batch:                      # published speaker-as-
        # codec-token conditioning (ids from talker_config.speaker_id)
        spk = codec_emb[batch["speaker_token"]]
        parts.append(pad_e[None, None, :] + spk[:, None, :])
    elif "speaker_id" in batch:                       # synthetic table row
        spk = params["spk_emb"][batch["speaker_id"].clamp(min=0)]
        parts.append(pad_e[None, None, :] + spk[:, None, :].to(txt.dtype))
    parts.append(brow(bos_e + codec_emb[t.codec_pad]))
    parts.append(
        txt[:, n_head:n_head + 1] + codec_emb[t.codec_bos][None, None, :]
    )

    # trailing-text rows for frames 0..Tf-1 (the input consuming frame g's
    # codes adds trail(g), as the decode loop's carried counter does)
    n_real = text_mask.int().sum(dim=1)                      # [B]
    idx = n_head + 1 + torch.arange(Tf, device=dev)          # [Tf]
    gathered = txt[:, idx.clamp(0, Tt - 1)]                  # [B, Tf, D]
    real = (idx[None, :] < n_real[:, None])[..., None]
    at_eos = (idx[None, :] == n_real[:, None])[..., None]
    trail = torch.where(real, gathered, torch.where(at_eos, eos_e, pad_e))

    # per-frame feedback embedding: cb0 + teacher-forced residual sum
    # (e_partial, the MTP-chain conditioning) + its trailing-text row
    cb0_in = codec_emb[codes0]                               # [B, Tf, D]
    res2d = codes[:, 1:, :].permute(0, 2, 1).reshape(B * Tf, -1)
    res_sum = residual_feedback_sum(cp_params, res2d).reshape(B, Tf, D)
    e_partial = (cb0_in + res_sum.to(txt.dtype)).to(txt.dtype)
    e_full = (e_partial + trail).to(txt.dtype)

    K = Tf // fps                                            # talker steps
    if fps == 1:
        frame_in = e_full[:, :-1]
    else:
        # MTP: one merged input per step of fps frames (the decode loop's
        # merge_step_embs over the full feedback embeddings)
        merged = merge_step_embs(
            params, t, e_full.reshape(B * K, fps, D)).reshape(B, K, D)
        frame_in = merged[:, :-1].to(txt.dtype)

    x = torch.cat(parts + [frame_in], dim=1)
    P = x.shape[1] - (K - 1)                                 # prompt length
    shift = torch.zeros((B,), dtype=torch.long, device=dev)  # no left pad
    hidden, logits = _talker_stack(params, t, x, shift, remat, hooks)
    if hidden is None:
        return None, None
    # the codec_bos row sits at P-1; its output predicts step 0
    step_hidden = hidden[:, P - 1:, :]                       # [B, K, D]
    step_logits = logits[:, P - 1:, :]
    if fps == 1:
        return step_hidden, step_logits

    # teacher-forced MTP chain: frame j of a step scores through the
    # shared head from the chain hidden conditioned on frame j-1's
    # embedding; the chain hidden also conditions frame j's code-predictor
    # pass in decode, so it is what is returned for frame j
    cond_src = cb0_in if t.mtp_cp_batch else e_partial
    ep = cond_src.reshape(B, K, fps, D)
    per_frame_logits = [step_logits]
    per_frame_hidden = [step_hidden]
    h = step_hidden.reshape(B * K, D)
    for j in range(1, fps):
        cond = ep[:, :, j - 1].reshape(B * K, D).to(h.dtype)
        lg, h = mtp_logits_emb(params, t, h, cond)
        per_frame_logits.append(lg.reshape(B, K, -1))
        per_frame_hidden.append(h.reshape(B, K, D))
    logits_frames = torch.stack(per_frame_logits, dim=2).reshape(B, Tf, -1)
    hidden_frames = torch.stack(per_frame_hidden, dim=2).reshape(B, Tf, D)
    return hidden_frames, logits_frames


def _talker_hidden_and_logits(
    params: Any, cfg: ModelConfig, batch: dict, cp_params: Any = None,
    remat: bool = False, hooks: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; returns (hidden, logits) at frame positions,
    or (None, None) on a pipeline stage other than the last (``hooks``:
    ``_talker_stack``).

    The conditioning layout mirrors inference exactly: text is LEFT-padded
    (each example's tokens are shifted right so the real text ends
    immediately before BOS) and the per-example pad length is masked out of
    attention via ``pad_len``, as runtime prompts left-pad to buckets.
    Frames are causal, so right-padded trailing frames are harmless for
    valid positions."""
    t = cfg.talker
    if t.feedback == "residual_sum":
        if cp_params is None:
            raise ValueError(
                "feedback='residual_sum' training needs cp_params (the "
                "talker input sums the predictor's depth-table embeddings)"
                " — use joint_loss, or pass cp_params explicitly"
            )
        return _published_hidden_and_logits(params, cp_params, cfg, batch,
                                            remat, hooks)
    text = batch["text_tokens"]                       # [B, Tt] right-padded
    text_mask = batch["text_mask"]                    # [B, Tt] bool
    codes0 = batch["codes"][:, 0, :]                  # [B, Tf]
    B, Tt = text.shape
    dev = text.device

    # optional speaker conditioning: inference prompts lead with the
    # speaker embedding row, so fine-tunes see the same
    # [pad][spk][text][BOS][frames] layout; speaker_id -1 (or absent) is
    # an unconditioned example
    spk_id = batch.get("speaker_id")
    if spk_id is None:
        spk_id = torch.full((B,), -1, dtype=torch.long, device=dev)
    have_spk = (spk_id >= 0).long()                          # [B]

    n_real = text_mask.long().sum(dim=1)                     # [B]
    W = Tt + 1                                               # room for spk
    shift = W - n_real - have_spk                            # [B] pad length

    # right layout [spk][text_real][text_pad] -> gather into left layout;
    # rows without a speaker start the gather one past the spk row. Rows
    # before `shift` are left padding (masked via pad_len below).
    spk_row = params["spk_emb"][spk_id.clamp(min=0)][:, None, :]  # [B, 1, D]
    text_emb_r = params["text_emb"][text]                    # [B, Tt, D]
    seq_r = torch.cat([spk_row.to(text_emb_r.dtype), text_emb_r], dim=1)
    src = (torch.arange(W, device=dev)[None, :] - shift[:, None]
           + (1 - have_spk)[:, None]).clamp(0, W - 1)        # [B, W]
    D = seq_r.shape[-1]
    text_emb = torch.gather(seq_r, 1, src[:, :, None].expand(B, W, D))
    # codec prompt head (when the checkpoint defines the ids) then BOS:
    # the inference layout (runtime/prompts.py)
    head_rows = [params["codec_emb"][i][None, None, :].expand(B, 1, D)
                 for i in t.codec_prompt_head]
    bos = params["codec_emb"][t.codec_bos][None, None, :].expand(B, 1, D)
    fps = t.frames_per_step
    Tf = codes0.shape[1]
    if fps == 1:
        frame_in = params["codec_emb"][codes0[:, :-1]]
    else:
        # MTP layout: the talker consumes one merged embedding per step of
        # fps frames (models/talker.py merge_step_tokens), as decode does
        assert Tf % fps == 0, (
            f"frames {Tf} must be a multiple of frames_per_step {fps}"
        )
        K = Tf // fps
        merged = merge_step_tokens(
            params, t, codes0.reshape(B * K, fps)).reshape(B, K, -1)
        frame_in = merged[:, :-1].to(text_emb.dtype)
    x = torch.cat([text_emb, *head_rows, bos, frame_in], dim=1)
    W = W + len(head_rows)  # BOS position shifts past the prompt head

    hidden, logits = _talker_stack(params, t, x, shift, remat, hooks)
    if hidden is None:
        return None, None
    # BOS sits at index W; its output predicts step 0, so positions W+k
    # hold the prediction for step k
    step_hidden = hidden[:, W:, :]
    step_logits = logits[:, W:, :]
    if fps == 1:
        return step_hidden, step_logits

    # teacher-forced MTP chain: step hidden + ground-truth frame j-1 token
    # -> frame j logits through the shared head (as decode)
    K = step_hidden.shape[1]
    grouped = codes0.reshape(B, K, fps)
    per_frame = [step_logits]                             # frame 0 of step
    h = step_hidden.reshape(B * K, D)
    for j in range(1, fps):
        lg, h = mtp_logits(params, t, h, grouped[:, :, j - 1].reshape(B * K))
        per_frame.append(lg.reshape(B, K, -1))
    # interleave: [B, K, fps, V] -> [B, Tf, V]
    logits_frames = torch.stack(per_frame, dim=2).reshape(B, K * fps, -1)
    hidden_frames = torch.repeat_interleave(step_hidden, fps, dim=1)
    return hidden_frames, logits_frames


def talker_loss(params: Any, cfg: ModelConfig, batch: dict,
                cp_params: Any = None, remat: bool = False) -> torch.Tensor:
    """Codebook-0 next-frame cross entropy. ``cp_params`` is required
    under feedback='residual_sum' (the talker input embeds residual codes
    through the predictor's depth tables)."""
    _, logits = _talker_hidden_and_logits(params, cfg, batch,
                                          cp_params=cp_params, remat=remat)
    return _cross_entropy(logits, batch["codes"][:, 0, :], batch["frame_mask"])


def code_predictor_teacher_logits(
    cp_params: Any, cfg: ModelConfig, talker_hidden: torch.Tensor,
    codes: torch.Tensor, remat: bool = False,
) -> torch.Tensor:
    """Teacher-forced depth transformer.

    talker_hidden [N, D_talker] (N = B*T_f flattened frames), codes [N, Q]
    ground truth. Returns float32 logits [N, Q-1, V_res]: depth step d
    predicts codes[:, d+1] given hidden, cb0 and residuals < d+1.
    ``depth_group=k`` teacher-forces the grouped layout (k heads score each
    position; the next position's input is the sum of the previous group's
    ground-truth embeddings); k == 1 is the published layout. With k > 1 a
    ``draft`` subtree (freeze-base recovery) is what the grouped layout
    reads, so the primary tree stays the raw import's."""
    cp = cfg.code_predictor
    cc = cfg.codec
    n_res = cc.num_codebooks - 1
    k = cp.depth_group
    n_groups = n_res // k
    N = talker_hidden.shape[0]
    hidden_token = cp.input_layout == "hidden_token"
    if k > 1 and "draft" in cp_params:
        cp_params = cp_params["draft"]

    cos_t, sin_t = rope_tables(n_groups + 2, cp.head_dim, cp.rope_theta,
                               talker_hidden.device)

    hid = talker_hidden[:, None, :]
    if cp.input_proj:
        hid = linear(hid, cp_params["in_proj"])
    cb0 = cp_params["cb0_emb"][codes[:, 0]][:, None, :]
    if hidden_token:
        # published layout: [hidden, cb0] as two positions; position p+1's
        # heads score group p
        tf_in = [hid, cb0.to(hid.dtype)]
    else:
        tf_in = [hid + cb0]
    # teacher inputs for group g>=1: summed embeddings of group g-1's
    # ground-truth residuals (decode's next_input)
    for g in range(n_groups - 1):
        emb = sum(
            cp_params["res_emb"][g * k + j][codes[:, 1 + g * k + j]]
            for j in range(k)
        )
        tf_in.append(emb[:, None, :].to(hid.dtype))
    x = torch.cat(tf_in, dim=1)             # [N, n_groups (+1 if 2-pos), H]

    T_depth = x.shape[1]
    x = run_blocks(cp_params["blocks"], x, cos=cos_t[:T_depth],
                   sin=sin_t[:T_depth], n_heads=cp.n_heads,
                   n_kv_heads=cp.n_heads, head_dim=cp.head_dim,
                   rms_eps=cp.rms_eps, qk_norm=cp.qk_norm, remat=remat)
    h = rmsnorm(x, cp_params["ln_f"], cp.rms_eps)      # [N, T_depth, H]
    if hidden_token:
        h = h[:, 1:, :]  # group g scores position g+1 (the decode layout)
    # position g's k heads score depth slots g*k .. g*k+k-1
    V = cp_params["heads"].shape[1]
    heads = cp_params["heads"].reshape(n_groups, k, V, -1)
    return torch.einsum("ngh,gkvh->ngkv", h.float(),
                        heads.float()).reshape(N, n_res, V)


def _flat_frames(batch: dict, hidden: torch.Tensor):
    """(hidden [B*Tf, D], codes [B*Tf, Q], residual mask [B*Tf, Q-1])."""
    B, Tf, D = hidden.shape
    Q = batch["codes"].shape[1]
    flat_codes = batch["codes"].permute(0, 2, 1).reshape(B * Tf, Q)
    mask = batch["frame_mask"].reshape(B * Tf, 1).expand(B * Tf, Q - 1)
    return hidden.reshape(B * Tf, D), flat_codes, mask


def code_predictor_loss(params: Any, cp_params: Any, cfg: ModelConfig,
                        batch: dict, remat: bool = False) -> torch.Tensor:
    hidden, _ = _talker_hidden_and_logits(params, cfg, batch,
                                          cp_params=cp_params, remat=remat)
    flat_h, flat_codes, mask = _flat_frames(batch, hidden)
    logits = code_predictor_teacher_logits(cp_params, cfg, flat_h, flat_codes,
                                           remat=remat)
    return _cross_entropy(logits, flat_codes[:, 1:], mask)


def _kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
        mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Masked mean KL(teacher || student), nats, f32. Under a dp mesh: this
    rank's masked sum over the global count."""
    ls = torch.log_softmax(student_logits.float(), dim=-1)
    lt = torch.log_softmax(teacher_logits.float(), dim=-1)
    kl = torch.sum(torch.exp(lt) * (lt - ls), dim=-1)
    m = mask.float()
    return torch.sum(kl * m) / _count(m, mesh)


def sequential_distill_loss(
    params: Any, cp_params: Any, teacher: tuple, cfg_base: ModelConfig,
    batch: dict, remat: bool = False, *, stack_fn: Any = None, mesh=None,
    sequence_parallel: bool = False,
) -> torch.Tensor | None:
    """Function-space anchor for decode-recovery fine-tunes: KL(base model
    || student) on the sequential decode path (``cfg_base``: fps=1, dg=1)
    for both the talker's cb0 logits and the code predictor's per-depth
    logits, teacher-forced on the batch. The teacher forwards run without
    autograd (the JAX package's stop_gradient). ``stack_fn``, ``mesh`` and
    ``sequence_parallel``: as ``joint_loss`` (both passes run through the
    pipeline; None on a stage other than the last).

    A weight-space anchor (train.anchor_penalty) cannot hold greedy
    parity: decode turns on argmax, and grouped/MTP training reshapes the
    shared weights. This term pins the base shape's function instead: its
    optimum keeps sequential logits, hence greedy codes, at the base
    model's, while the grafted MTP chain and the grouped conditioning learn
    through the primary CE."""
    t_params, t_cp = teacher
    hooks = {"stack_fn": stack_fn, "mesh": mesh,
             "sequence_parallel": sequence_parallel}
    h_s, lg_s = _talker_hidden_and_logits(params, cfg_base, batch,
                                          cp_params=cp_params, remat=remat,
                                          hooks=hooks)
    with torch.no_grad():
        h_t, lg_t = _talker_hidden_and_logits(t_params, cfg_base, batch,
                                              cp_params=t_cp, hooks=hooks)
    if h_s is None:
        return None
    kl_talker = _kl(lg_s, lg_t, batch["frame_mask"], mesh)
    flat_s, flat_codes, mask = _flat_frames(batch, h_s)
    cp_lg_s = code_predictor_teacher_logits(cp_params, cfg_base, flat_s,
                                            flat_codes, remat=remat)
    with torch.no_grad():
        cp_lg_t = code_predictor_teacher_logits(
            t_cp, cfg_base, h_t.reshape(flat_s.shape), flat_codes)
    return kl_talker + _kl(cp_lg_s, cp_lg_t, mask, mesh)


def joint_loss(
    params: Any, cp_params: Any, cfg: ModelConfig, batch: dict,
    *, cp_weight: float = 1.0, remat: bool = False, stack_fn: Any = None,
    mesh=None, sequence_parallel: bool = False,
) -> tuple[torch.Tensor | None, dict]:
    """Talker CE + weighted residual-predictor CE, sharing one talker pass.
    Returns (total, {"talker_loss", "cp_loss", "loss"}); (None, {}) on a
    pipeline stage other than the last. ``stack_fn``, ``mesh`` and
    ``sequence_parallel``: training across ranks (module docstring)."""
    hooks = {"stack_fn": stack_fn, "mesh": mesh,
             "sequence_parallel": sequence_parallel}
    hidden, logits = _talker_hidden_and_logits(
        params, cfg, batch, cp_params=cp_params, remat=remat, hooks=hooks)
    if hidden is None:
        return None, {}
    t_loss = _cross_entropy(logits, batch["codes"][:, 0, :],
                            batch["frame_mask"], mesh)
    flat_h, flat_codes, mask = _flat_frames(batch, hidden)
    cp_logits = code_predictor_teacher_logits(cp_params, cfg, flat_h,
                                              flat_codes, remat=remat)
    cp_loss = _cross_entropy(cp_logits, flat_codes[:, 1:], mask, mesh)
    total = t_loss + cp_weight * cp_loss
    return total, {"talker_loss": t_loss, "cp_loss": cp_loss, "loss": total}
