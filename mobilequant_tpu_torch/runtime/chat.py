"""Chat prompt templates (the port's own copy of
mobilequant_tpu/runtime/chat.py): a string template per model family, and the
tokenized form, whose special tokens resolve to single ids and whose text
segments are tokenized on their own, so the ids never depend on what
surrounds them."""

from __future__ import annotations

CHAT_TEMPLATES = {
    # TinyLlama-1.1B-Chat (zephyr format)
    "llama": ("<|system|>\nYou are a friendly chatbot.</s>\n"
              "<|user|>\n{prompt}</s>\n<|assistant|>\n"),
    # Gemma instruction format
    "gemma": ("<start_of_turn>user\n{prompt}<end_of_turn>\n"
              "<start_of_turn>model\n"),
    # StableLM-2 zephyr format
    "stablelm": ("<|user|>\n{prompt}<|endoftext|>\n<|assistant|>\n"),
    "none": "{prompt}",
}


def apply_chat_template(prompt: str, family: str = "none") -> str:
    tpl = CHAT_TEMPLATES.get(family)
    if tpl is None:
        raise KeyError(f"unknown chat family {family!r}; known: {sorted(CHAT_TEMPLATES)}")
    return tpl.format(prompt=prompt)


# Tokenized templates: each entry is (kind, text) with kind "special" (an
# atomic vocab-id lookup), "text" (tokenized as its own segment) or "prompt"
# (the caller's pre-tokenized ids). String-level templating can shift ids at
# segment boundaries (sentencepiece prefix spaces, merges across a boundary).
# The strings equal the JAX package's (tests/test_torch_serve.py holds them).
TEMPLATE_SEGMENTS = {
    "llama": (("special", "<|system|>"),
              ("text", "\nYou are a friendly chatbot."),
              ("special", "</s>"), ("text", "\n"),
              ("special", "<|user|>"), ("text", "\n"),
              ("prompt", None),
              ("special", "</s>"), ("text", "\n"),
              ("special", "<|assistant|>"), ("text", "\n")),
    "gemma": (("special", "<start_of_turn>"), ("text", "user\n"),
              ("prompt", None),
              ("special", "<end_of_turn>"), ("text", "\n"),
              ("special", "<start_of_turn>"), ("text", "model\n")),
    "stablelm": (("special", "<|user|>"), ("text", "\n"),
                 ("prompt", None),
                 ("special", "<|endoftext|>"), ("text", "\n"),
                 ("special", "<|assistant|>"), ("text", "\n")),
    "none": (("prompt", None),),
}


def apply_chat_template_ids(prompt_ids, family, encode_fn, piece_to_id_fn):
    """Exact-id chat template: prefix ids + the caller's pre-tokenized prompt
    ids + suffix ids. Special tokens resolve atomically via piece_to_id_fn
    (falling back to encode_fn for vocabs without them, e.g. byte-fallback
    test tokenizers); plain text segments go through encode_fn in isolation,
    so the resulting ids never depend on what surrounds them."""
    segs = TEMPLATE_SEGMENTS.get(family)
    if segs is None:
        raise KeyError(f"unknown chat family {family!r}; "
                       f"known: {sorted(TEMPLATE_SEGMENTS)}")
    out = []
    for kind, text in segs:
        if kind == "prompt":
            out.extend(int(t) for t in prompt_ids)
        elif kind == "special":
            tid = piece_to_id_fn(text)
            if tid is not None and tid >= 0:
                out.append(int(tid))
            else:
                out.extend(int(t) for t in encode_fn(text))
        else:
            out.extend(int(t) for t in encode_fn(text))
    return out
