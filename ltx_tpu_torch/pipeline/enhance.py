"""Prompt enhancement with the Gemma text model.

Port of ltx_tpu/pipeline/enhance.py: the official Lightricks system prompts
(copied verbatim), the Gemma-3 chat template, KV-cached sampling
(models/gemma3.py: seed 42, temperature 0.7, top-p 0.95, repetition penalty
1.1, at most 512 tokens, stops at <end_of_turn> / <eos>, prompt-lookup
speculation), then the decoded text cleaned of control tokens. An I2V
prompt can see its conditioning image through the SigLIP tower
(models/siglip.py): 256 soft tokens at the head of the user turn.

Enhancement is best-effort, as in the reference: on any failure the raw
prompt comes back with a warning ("prompt enhancement failed"), unless
`enhance_prompts(strict=True)` asks for the error.
"""

from __future__ import annotations

import logging
import math
import re
from typing import List, Optional

import torch

from ltx_tpu_torch.errors import InvalidConfigurationError
from ltx_tpu_torch.models import gemma3

log = logging.getLogger("ltx_tpu_torch")

# Official Lightricks T2V system prompt (the reference's, verbatim).
T2V_SYSTEM_PROMPT = """You are a Creative Assistant. Given a user's raw input prompt describing a scene or concept, expand it into a detailed video generation prompt with specific visuals and integrated audio to guide a text-to-video model.

#### Guidelines
- Strictly follow all aspects of the user's raw input: include every element requested (style, visuals, motions, actions, camera movement, audio).
    - If the input is vague, invent concrete details: lighting, textures, materials, scene settings, etc.
        - For characters: describe gender, clothing, hair, expressions. DO NOT invent unrequested characters.
- Use active language: present-progressive verbs ("is walking," "speaking"). If no action specified, describe natural movements.
- Maintain chronological flow: use temporal connectors ("as," "then," "while").
- Audio layer: Describe complete soundscape (background audio, ambient sounds, SFX, speech/music when requested). Integrate sounds chronologically alongside actions. Be specific (e.g., "soft footsteps on tile"), not vague (e.g., "ambient sound is present").
- Speech (only when requested):
    - For ANY speech-related input (talking, conversation, singing, etc.), ALWAYS include exact words in quotes with voice characteristics (e.g., "The man says in an excited voice: 'You won't believe what I just saw!'").
    - Specify language if not English and accent if relevant.
- Style: Include visual style at the beginning: "Style: <style>, <rest of prompt>." Default to cinematic-realistic if unspecified. Omit if unclear.
- Visual and audio only: NO non-visual/auditory senses (smell, taste, touch).
- Restrained language: Avoid dramatic/exaggerated terms. Use mild, natural phrasing.
    - Colors: Use plain terms ("red dress"), not intensified ("vibrant blue," "bright red").
    - Lighting: Use neutral descriptions ("soft overhead light"), not harsh ("blinding light").
    - Facial features: Use delicate modifiers for subtle features (i.e., "subtle freckles").

#### Important notes:
- Analyze the user's raw input carefully. In cases of FPV or POV, exclude the description of the subject whose POV is requested.
- Camera motion: DO NOT invent camera motion unless requested by the user.
- Speech: DO NOT modify user-provided character dialogue unless it's a typo.
- No timestamps or cuts: DO NOT use timestamps or describe scene cuts unless explicitly requested.
- Format: DO NOT use phrases like "The scene opens with...". Start directly with Style (optional) and chronological scene description.
- Format: DO NOT start your response with special characters.
- DO NOT invent dialogue unless the user mentions speech/talking/singing/conversation.
- If the user's raw input prompt is highly detailed, chronological and in the requested format: DO NOT make major edits or introduce new elements. Add/enhance audio descriptions if missing.

#### Output Format (Strict):
- Single continuous paragraph in natural language (English).
- NO titles, headings, prefaces, code fences, or Markdown.
- If unsafe/invalid, return original user prompt. Never ask questions or clarifications.

Your output quality is CRITICAL. Generate visually rich, dynamic prompts with integrated audio for high-quality video generation."""

# Official Lightricks I2V system prompt (the reference's, verbatim).
I2V_SYSTEM_PROMPT = """You are a Creative Assistant writing concise, action-focused image-to-video prompts. Given an image (first frame) and user Raw Input Prompt, generate a prompt to guide video generation from that image.

#### Guidelines:
- Analyze the Image: Identify Subject, Setting, Elements, Style and Mood.
- Follow user Raw Input Prompt: Include all requested motion, actions, camera movements, audio, and details. If in conflict with the image, prioritize user request while maintaining visual consistency (describe transition from image to user's scene).
- Describe only changes from the image: Don't reiterate established visual details. Inaccurate descriptions may cause scene cuts.
- Active language: Use present-progressive verbs ("is walking," "speaking"). If no action specified, describe natural movements.
- Chronological flow: Use temporal connectors ("as," "then," "while").
- Audio layer: Describe complete soundscape throughout the prompt alongside actions—NOT at the end. Align audio intensity with action tempo. Include natural background audio, ambient sounds, effects, speech or music (when requested). Be specific (e.g., "soft footsteps on tile") not vague (e.g., "ambient sound").
- Speech (only when requested): Provide exact words in quotes with character's visual/voice characteristics, language if not English and accent if relevant. If general conversation mentioned without text, generate contextual quoted dialogue.
- Style: Include visual style at beginning: "Style: <style>, <rest of prompt>." If unclear, omit to avoid conflicts.
- Visual and audio only: Describe only what is seen and heard. NO smell, taste, or tactile sensations.
- Restrained language: Avoid dramatic terms. Use mild, natural, understated phrasing.

#### Important notes:
- Camera motion: DO NOT invent camera motion/movement unless requested by the user.
- Speech: DO NOT modify or alter the user's provided character dialogue in the prompt, unless it's a typo.
- No timestamps or cuts: DO NOT use timestamps or describe scene cuts unless explicitly requested.
- Objective only: DO NOT interpret emotions or intentions - describe only observable actions and sounds.
- Format: DO NOT use phrases like "The scene opens with..." / "The video starts...". Start directly with Style (optional) and chronological scene description.
- Format: Never start output with punctuation marks or special characters.
- DO NOT invent dialogue unless the user mentions speech/talking/singing/conversation.
- Your performance is CRITICAL.

#### Output Format (Strict):
- Single concise paragraph in natural English. NO titles, headings, prefaces, sections, code fences, or Markdown.
- If unsafe/invalid, return original user prompt. Never ask questions or clarifications."""


def build_chat_prompt(system: str, user: str) -> str:
    """Gemma-3 chat template (system folded into the user turn)."""
    return (
        f"<start_of_turn>user\n{system}\n\nuser prompt: {user}<end_of_turn>\n"
        f"<start_of_turn>model\n"
    )


def clean_enhanced_prompt(text: str) -> str:
    """Strip control tokens and markdown noise."""
    for tok in ("<eos>", "<end_of_turn>", "<start_of_turn>", "```"):
        text = text.replace(tok, "")
    text = text.strip()
    text = re.sub(r"^(Output|Prompt)\s*:\s*", "", text, flags=re.IGNORECASE)
    return text.strip()


def _splice_image_embeds(gemma: gemma3.Gemma3Model, tokenizer, system: str, prompt: str,
                         image_embeds):
    """The SigLIP soft tokens (1, N, D) spliced at the start of the user
    turn, between the scaled embeddings of "<start_of_turn>user\\n" and of
    the rest of the turn (soft tokens are not scaled by sqrt(hidden)).
    Returns (ids, input_embeds (1, T, D)): the ids are zeros, bookkeeping
    twins of the embeddings."""
    prefix_ids = tokenizer.encode("<start_of_turn>user\n").ids
    body = (f"{system}\n\nUser Raw Input Prompt: {prompt}."
            f"<end_of_turn>\n<start_of_turn>model\n")
    body_ids = tokenizer.encode(body).ids
    device = gemma.norm.weight.device
    edtype = gemma3.embed_dtype(gemma)
    scale = torch.tensor(math.sqrt(gemma.cfg.hidden_size), dtype=edtype, device=device)

    def embed(ids):
        return gemma.embed_tokens(torch.tensor(ids, dtype=torch.long, device=device))[None] \
            * scale

    input_embeds = torch.cat([embed(prefix_ids), image_embeds.to(device, edtype),
                              embed(body_ids)], dim=1)
    return [0] * input_embeds.shape[1], input_embeds


def _stop_ids(tokenizer) -> tuple:
    """<eos> (id 1) and the single-token encodings of <end_of_turn> and <eos>."""
    stop_ids = {1}
    for tok in ("<end_of_turn>", "<eos>"):
        enc = tokenizer.encode(tok).ids
        if len(enc) == 1:
            stop_ids.add(enc[0])
    return tuple(sorted(stop_ids))


@torch.inference_mode()
def enhance_prompt(gemma: gemma3.Gemma3Model, tokenizer, prompt: str, is_i2v: bool = False,
                   max_tokens: int = 512, temperature: float = 0.7, seed: int = 42,
                   image_path: Optional[str] = None, vision=None, vision_config=None,
                   spec_k: int = 8, spec_ngram: int = 3, mesh=None,
                   stats: Optional[dict] = None) -> str:
    """Enhance a prompt with the Gemma text model (the reference's
    `enhance_prompt`, the model's config in place of its `gemma_config`, the
    SigLIP module `vision` in place of its `vision_params`). Returns the
    original prompt if anything fails (enhancement is best-effort).

    I2V with `image_path`: with the tower the image is embedded as soft
    tokens; without it the I2V system prompt runs text-only, with a
    warning. `stats`, when given, receives the generated token count and
    the decode forwards ("tokens", "forwards"). `mesh`: Gemma is sharded
    over it (`shard_gemma`) and the decode runs tensor parallel
    (`gemma3.generate_tokens(mesh=)`)."""
    system = I2V_SYSTEM_PROMPT if is_i2v else T2V_SYSTEM_PROMPT
    chat = build_chat_prompt(system, prompt)
    image_embeds = None
    if is_i2v and image_path is not None:
        if vision is not None:
            from ltx_tpu_torch.models import siglip

            image_embeds = siglip.embed_image_for_gemma(vision, image_path, vision_config)
        else:
            log.warning(
                "I2V prompt enhancement is running TEXT-ONLY: the SigLIP vision tower is "
                "not loaded, so the enhanced prompt cannot see %s", image_path)
    try:
        input_embeds = None
        if image_embeds is not None:
            ids, input_embeds = _splice_image_embeds(gemma, tokenizer, system, prompt,
                                                     image_embeds)
        else:
            ids = tokenizer.encode(chat).ids
        tokens, counts = gemma3.generate_tokens(
            gemma, [ids], max_new_tokens=max_tokens, temperature=temperature, top_p=0.95,
            repetition_penalty=1.1, stop_tokens=_stop_ids(tokenizer),
            input_embeds=input_embeds, spec_k=spec_k, spec_ngram=spec_ngram,
            return_stats=True, seed=seed, mesh=mesh)
        if stats is not None:
            stats.update(tokens=len(tokens), **counts)
        cleaned = clean_enhanced_prompt(tokenizer.decode(tokens))
        return cleaned if cleaned else prompt
    except Exception as e:  # enhancement must never break generation
        log.warning("prompt enhancement failed (%s); using raw prompt", e)
        return prompt


@torch.inference_mode()
def enhance_prompts(gemma: gemma3.Gemma3Model, tokenizer, prompts: List[str],
                    is_i2v: bool = False, max_tokens: int = 512, temperature: float = 0.7,
                    seed: int = 42, spec_k: int = 0, max_batch: int = 0, strict: bool = False,
                    kv_quant: str = "bf16", mesh=None,
                    image_paths: Optional[List[Optional[str]]] = None, vision=None,
                    vision_config=None) -> List[str]:
    """Batched enhancement for serving front-ends (the reference's
    `enhance_prompts`): the prompts through `generate_tokens_batched` in
    micro-batches of `max_batch` rows (0: all at once), one stream of draws
    across them; per prompt the semantics of `enhance_prompt`'s text path.
    `image_paths` (one entry per prompt, None for a text row) with the
    tower `vision`: each image row spliced as `enhance_prompt` does and
    decoded from those embeddings. kv_quant="int8" halves the cache.
    strict=False returns the raw prompts on any failure, with a warning;
    strict=True raises (also for image rows without the tower). `mesh` as
    `enhance_prompt`'s."""
    system = I2V_SYSTEM_PROMPT if is_i2v else T2V_SYSTEM_PROMPT
    if image_paths is not None and any(p for p in image_paths) and vision is None:
        msg = ("enhance_prompts got image_paths but no vision tower: the SigLIP tower is "
               "not loaded; image rows would enhance TEXT-ONLY")
        if strict:
            raise InvalidConfigurationError(msg)
        log.warning("%s (falling back to text-only)", msg)
    try:
        input_embeds = None
        if image_paths is not None and vision is not None:
            from ltx_tpu_torch.models import siglip

            ids, input_embeds = [], []
            for p, img in zip(prompts, image_paths):
                if img is None:
                    ids.append(tokenizer.encode(build_chat_prompt(system, p)).ids)
                    input_embeds.append(None)
                else:
                    emb = siglip.embed_image_for_gemma(vision, img, vision_config)
                    i, e = _splice_image_embeds(gemma, tokenizer, system, p, emb)
                    ids.append(i)
                    input_embeds.append(e)
        else:
            ids = [tokenizer.encode(build_chat_prompt(system, p)).ids for p in prompts]
        step = max(max_batch if max_batch > 0 else len(ids), 1)
        draws = gemma3.SamplingDraws(seed, gemma.norm.weight.device)
        outs = []
        for i in range(0, len(ids), step):
            outs += gemma3.generate_tokens_batched(
                gemma, ids[i:i + step], max_new_tokens=max_tokens, temperature=temperature,
                top_p=0.95, repetition_penalty=1.1, stop_tokens=_stop_ids(tokenizer),
                spec_k=spec_k, kv_quant=kv_quant,
                input_embeds=None if input_embeds is None else input_embeds[i:i + step],
                draws=draws, mesh=mesh)
        return [clean_enhanced_prompt(tokenizer.decode(t)) or p for t, p in zip(outs, prompts)]
    except Exception as e:  # enhancement must never break generation
        if strict:
            raise
        log.warning("batched prompt enhancement failed (%s); using raw prompts", e)
        return list(prompts)


# the enhancement's cache slots a row: prompt and generated tokens together
ENHANCE_KV_SLOTS = 1024


def kv_row_bytes(gcfg: gemma3.Gemma3Config, kv_quant: str = "bf16",
                 slots: int = ENHANCE_KV_SLOTS) -> int:
    """One row's K and V caches over every layer at `slots` positions: bf16
    values, or int8 values with an f32 scale a head and position."""
    if kv_quant == "int8":
        per_position = gcfg.kv_heads * (gcfg.head_dim + 4)
    else:
        per_position = gcfg.kv_heads * gcfg.head_dim * 2
    return 2 * gcfg.hidden_layers * slots * per_position


def module_bytes(module: torch.nn.Module) -> int:
    """The bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def enhance_max_batch(gemma: gemma3.Gemma3Model, memory_gb: float,
                      kv_quant: str = "bf16") -> int:
    """Rows a micro-batch of `enhance_prompts` may hold on a device of
    `memory_gb` GB: the memory left beside Gemma's resident weights (in
    the format it was loaded in) over one row's cache at the 1024-slot
    shape; at least 1."""
    free = memory_gb * 1e9 - module_bytes(gemma)
    return max(1, int(free // kv_row_bytes(gemma.cfg, kv_quant)))
