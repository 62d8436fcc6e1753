"""Conversation templates (vicuna v1.1, llama-2) for SFT data and eval
prompts — reference omni/conversation/conversation.py:16-147.

Rendered as *segments* rather than one flat string so the builder can mask
labels per-turn without re-tokenizing prefixes (the reference recovers turn
boundaries by counting tokens with legacy-SPM offset hacks,
builder_dreamllm.py:358-433 — we keep explicit structure instead and the
offsets disappear).

A copy of ``dreamllm_tpu/data/conversation.py`` with its import pointed at
the port: the two render every template to the same string."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from dreamllm_tpu_torch.data.dataset_types import Message


@dataclasses.dataclass(frozen=True)
class ConvTemplate:
    name: str
    system: str
    roles: tuple[str, str]          # (user tag, assistant tag)
    sep_style: str                  # "add_colon_two" | "llama2" | "single" | "mpt"
    seps: tuple[str, str]
    # seeded demo turns rendered before the real dialog, NEVER learnable —
    # the reference's ``messages=`` + ``offset`` mechanism (the `multimodal`
    # template seeds a greeting exchange, `dream_conv` a one-shot
    # interleaved-writing example; conversation.py:322-331,370-414)
    seed_messages: tuple = ()       # ((role, content), ...), roles user/assistant


VICUNA_V11 = ConvTemplate(
    name="vicuna_v1.1",
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style="add_colon_two",
    seps=(" ", "</s>"),
)

LLAMA2 = ConvTemplate(
    name="llama2",
    system="",
    roles=("[INST]", "[/INST]"),
    sep_style="llama2",
    seps=(" ", " </s>"),
)

# v0-style single-separator template (reference conv_v1 / simple_conv,
# omni/utils/conversation.py:201-228,312-320): every turn ends with the SAME
# separator ("###"), which is NOT the EOS token — generation must stop on the
# decoded stop string (generation/stopping.py), exactly the case the
# reference handles with KeywordsStoppingCriteria.
VICUNA_V0 = ConvTemplate(
    name="vicuna_v0",
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    sep_style="single",
    seps=("###", "###"),
)

# ChatML/MPT style (reference conv_mpt/conv_mpt_text/simple_conv_mpt_multimodal,
# conversation.py:275-300,333-344): role tags carry "<|im_start|>role\n",
# every turn closes with "<|im_end|>" — a stop string, not EOS.
MPT = ConvTemplate(
    name="mpt",
    system=(
        "<|im_start|>system\n"
        "- You are a helpful language and vision assistant.\n"
        "- You are able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using natural "
        "language.\n"
        "- You should follow the instructions carefully and explain your "
        "answers in detail."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style="mpt",
    seps=("<|im_end|>", "<|im_end|>"),
)

# reference conv_llava_v1 (conversation.py:357-368): vicuna-v1.1 mechanics
# with the LLaVA system prompt
LLAVA_V1 = ConvTemplate(
    name="llava_v1",
    system=(
        "You are LLaVA, a large language and vision assistant trained by UW "
        "Madison WAIV Lab."
        "You are able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using natural "
        "language."
        "Follow the instructions carefully and explain your answers in detail."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style="add_colon_two",
    seps=(" ", "</s>"),
)

# reference simple_conv_multimodal (conversation.py:322-331): ###-separated
# with a seeded greeting exchange (offset=2 — never learnable)
MULTIMODAL = ConvTemplate(
    name="multimodal",
    system=(
        "You are LLaVA, a large language and vision assistant trained by UW "
        "Madison WAIV Lab."
        "You are able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using natural "
        "language."
        "Follow the instructions carefully and explain your answers in detail."
    ),
    roles=("Human", "Assistant"),
    sep_style="single",
    seps=("###", "###"),
    seed_messages=(("user", "Hi!"),
                   ("assistant", "Hi there!  How can I help you today?\n")),
)

# reference dream_conversation (conversation.py:370-414): the
# interleaved-document-writing persona with a one-shot example teaching the
# model to emit <dream_start> <dream_end> spans mid-text. The reference's
# seed is a ~600-word article; this ships an abridged ORIGINAL example with
# the same mechanics (the spans are what condition interleaved generation).
DREAM_CONV = ConvTemplate(
    name="dream_conv",
    system=(
        " A chat between a curious user and an artificial intelligence "
        "assistant. The assistant writes engaged, and detailed articles/news/"
        "blogs/diaries/handbooks/menus/introductions with illustrations and "
        "text following user's instructions."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style="add_colon_two",
    seps=(" ", "</s>"),
    seed_messages=(
        ("user",
         "Title: \"A Morning in the Alpine Garden\"\n\nInstructions:\n"
         "1. Write a short illustrated blog post about tending an alpine "
         "rock garden at sunrise.\n2. Include pictures where they help the "
         "story.\n3. Length: 2-3 paragraphs."),
        ("assistant",
         "The first light catches the dew on the saxifrage cushions. "
         "<dream_start> <dream_end>  Up here the season starts late; the "
         "gentians are only now unfolding, a blue so saturated it looks "
         "painted. I loosen the gravel mulch around each crown and check "
         "for winter rot. <dream_start> <dream_end>  By the time the sun "
         "clears the ridge, the whole terrace is awake — and so, finally, "
         "am I."),
    ),
)

TEMPLATES = {t.name: t for t in (VICUNA_V11, LLAMA2, VICUNA_V0, MPT,
                                 LLAVA_V1, MULTIMODAL, DREAM_CONV)}


@dataclasses.dataclass
class Segment:
    text: str
    learnable: bool     # True → tokens contribute to the LM loss


def render_conversation(
    template: ConvTemplate,
    messages: Sequence[Message],
    system: str | None = None,
) -> list[Segment]:
    """Flatten a dialog into (text, learnable) segments.

    Only assistant replies (and their closing separator/EOS) are learnable —
    the reference's turn-masking semantics (builder_dreamllm.py:404-424).
    Seeded demo turns (``template.seed_messages``, the reference's
    ``messages=`` + ``offset``) render first and are NEVER learnable."""
    sys_text = system if system is not None else template.system
    if template.seed_messages:
        seeds = [Message(r, c) for r, c in template.seed_messages]
        n_seed = len(seeds)
        messages = seeds + [m for m in messages]
    else:
        n_seed = 0
    segs: list[Segment] = []
    if template.sep_style in ("add_colon_two", "single"):
        # "single" = reference SeparatorStyle.SINGLE (conversation.py:50-59):
        # system + sep, then "Role: msg" + sep per turn with ONE separator;
        # "add_colon_two" alternates seps[0]/seps[1] per role
        if sys_text or template.sep_style == "single":
            segs.append(Segment(sys_text + template.seps[0], False))
        for i, m in enumerate(messages):
            if m.role == "system":
                continue
            if m.role == "user":
                segs.append(Segment(f"{template.roles[0]}: {m.content}{template.seps[0]}", False))
            else:
                sep = template.seps[0] if template.sep_style == "single" else template.seps[1]
                segs.append(Segment(f"{template.roles[1]}: ", False))
                segs.append(Segment(m.content + sep, i >= n_seed))
    elif template.sep_style == "mpt":
        # reference SeparatorStyle.MPT (conversation.py:71-80): role tags
        # carry the ChatML header incl. newline; every turn (incl. user)
        # closes with the same sep
        segs.append(Segment(sys_text + template.seps[0], False))
        for i, m in enumerate(messages):
            if m.role == "system":
                continue
            if m.role == "user":
                segs.append(Segment(template.roles[0] + m.content + template.seps[0], False))
            else:
                segs.append(Segment(template.roles[1], False))
                segs.append(Segment(m.content + template.seps[0], i >= n_seed))
    elif template.sep_style == "llama2":
        # Exact string parity with the reference's default_chat_template
        # (tokenization_dreamllm.py:400-448): each exchange renders as
        # ``<s>[INST] Q [/INST] A </s>`` with the system prompt embedded in
        # the first user turn. The leading <s> of the FIRST turn is omitted
        # here — the builder prepends the bos token id itself.
        first = True
        for i, m in enumerate(messages):
            if m.role == "system":
                continue
            if m.role == "user":
                prefix = f"<<SYS>>\n{sys_text}\n<</SYS>>\n\n" if (first and sys_text) else ""
                bos = "" if first else "<s>"
                segs.append(
                    Segment(f"{bos}{template.roles[0]} {prefix}{m.content.strip()} {template.roles[1]}", False)
                )
                first = False
            else:
                # template.seps[1] (" </s>") rather than a hardcoded literal,
                # so llama2-style templates with different separators render
                # as configured
                segs.append(Segment(f" {m.content.strip()}{template.seps[1]}", i >= n_seed))
    else:
        raise ValueError(template.sep_style)
    return segs


def render_prompt(template: ConvTemplate, messages: Sequence[Message],
                  system: str | None = None) -> str:
    """Inference-time prompt: all turns + a trailing assistant header."""
    segs = render_conversation(template, messages, system)
    out = "".join(s.text for s in segs)
    if template.sep_style in ("add_colon_two", "single"):
        out += f"{template.roles[1]}:"
    elif template.sep_style == "mpt":
        # reference MPT prompt ends with the bare assistant header
        # (conversation.py:77-79 "else: ret += role")
        out += template.roles[1]
    return out
