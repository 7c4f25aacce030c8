"""Instruction set — the scheduling IR (port of hydrainfer_tpu/engine/isa.py).

A request becomes a doubly-linked instruction list, for an image request

    ImageEmbed → EPMigrate → PullCache → ImageEmbedFill(prefill) →
    PDMigrate → PullCache → Fill(decode) → Fill(decode) → ... → (tail)

and for a text request the same without the first three.

Fill unifies prefill and decode: a decode Fill is just a 1-token Fill whose
token id is filled in by its predecessor's `sample_dst` link at execution
time. `chunk_prefill` splits a Fill in place for chunked prefill and for
prefix-cache skips.
"""
from typing import List, Optional, Tuple


class Instruction:
    next: Optional["Instruction"] = None
    prev: Optional["Instruction"] = None

    def insert_next(self, inst: "Instruction") -> None:
        inst.next = self.next
        inst.prev = self
        if self.next is not None:
            self.next.prev = inst
        self.next = inst


class EmptyInstruction(Instruction):
    def __repr__(self):
        return "EM"


class Fill(Instruction):
    """One LM forward chunk of a request.

    token_ids:   tokens to feed (None for a decode Fill until its token
                 arrives via sample_dst)
    position_ids/cache_ids: absolute positions / virtual kv-cache slots
    sample:      whether this Fill's last token produces a next token
    sample_dst:  the decode Fill that receives the sampled token
    hashes:      per-block prefix hashes (prefill only)
    is_chunked:  True for the head part of a split Fill — its sampled token
                 is an artifact and must not be emitted
    """

    def __init__(self, token_ids: Optional[List[int]], position_ids: List[int],
                 cache_ids: List[int], sample: bool,
                 sample_dst: Optional["Fill"], hashes: Optional[List[int]]):
        self.token_ids = token_ids
        self.position_ids = position_ids
        self.cache_ids = cache_ids
        self.sample = sample
        self.sample_dst = sample_dst
        self.hashes = hashes
        self.is_chunked = False
        # M-RoPE h/w position streams ([h_list, w_list]); None = both equal
        # to position_ids (text tokens, or a model without M-RoPE)
        self.mrope_hw = None

    def n_tokens(self) -> int:
        return len(self.token_ids)

    def chunk_prefill(self, chunk_size: int) -> None:
        raise NotImplementedError


class TextFill(Fill):
    def chunk_prefill(self, chunk_size: int) -> None:
        assert 0 < chunk_size < len(self.token_ids), \
            f"invalid chunk size {chunk_size} for {len(self.token_ids)} tokens"
        rest = TextFill(
            token_ids=self.token_ids[chunk_size:],
            position_ids=self.position_ids[chunk_size:],
            cache_ids=self.cache_ids[chunk_size:],
            sample=self.sample,
            sample_dst=self.sample_dst,
            hashes=self.hashes,
        )
        self.insert_next(rest)
        _split_common(self, rest, chunk_size)

    def __repr__(self):
        return "TF"


def _split_common(head: Fill, rest: Fill, chunk_size: int) -> None:
    """Cut `head` to its first chunk_size tokens; `rest` holds the others."""
    if head.mrope_hw is not None:
        rest.mrope_hw = [a[chunk_size:] for a in head.mrope_hw]
        head.mrope_hw = [a[:chunk_size] for a in head.mrope_hw]
    head.token_ids = head.token_ids[:chunk_size]
    head.position_ids = head.position_ids[:chunk_size]
    head.cache_ids = head.cache_ids[:chunk_size]
    head.sample_dst = None
    head.is_chunked = True


class ImageEmbedFill(Fill):
    """Prefill whose token stream holds image-token runs; their embeddings are
    overwritten by the cached vision features.

    image_token_cache_ids: virtual image-cache slots feeding this chunk
    image_token_mask:      per-token flag, True at image positions
    """

    def __init__(self, image_token_cache_ids: List[int],
                 image_token_mask: List[bool], token_ids: Optional[List[int]],
                 position_ids: List[int], cache_ids: List[int], sample: bool,
                 sample_dst: Optional[Fill], hashes: Optional[List[int]]):
        super().__init__(token_ids, position_ids, cache_ids, sample, sample_dst, hashes)
        self.image_token_cache_ids = image_token_cache_ids
        self.image_token_mask = image_token_mask

    def chunk_prefill(self, chunk_size: int) -> None:
        assert 0 < chunk_size < len(self.token_ids), \
            f"invalid chunk size {chunk_size} for {len(self.token_ids)} tokens"
        n_img = sum(self.image_token_mask[:chunk_size])
        rest = ImageEmbedFill(
            image_token_cache_ids=self.image_token_cache_ids[n_img:],
            image_token_mask=self.image_token_mask[chunk_size:],
            token_ids=self.token_ids[chunk_size:],
            position_ids=self.position_ids[chunk_size:],
            cache_ids=self.cache_ids[chunk_size:],
            sample=self.sample,
            sample_dst=self.sample_dst,
            hashes=self.hashes,
        )
        self.insert_next(rest)
        self.image_token_cache_ids = self.image_token_cache_ids[:n_img]
        self.image_token_mask = self.image_token_mask[:chunk_size]
        _split_common(self, rest, chunk_size)

    def __repr__(self):
        return "EF"


class ImageEmbed(Instruction):
    """Run the vision tower and write its features into the image cache."""

    def __init__(self, pixel_values, cache_ids: List[int],
                 images_size: List[Tuple[int, int]], hashes: Optional[List[int]]):
        self.pixel_values = pixel_values     # numpy (n_patches, patch_dim)
        self.cache_ids = cache_ids
        self.images_size = images_size
        self.hashes = hashes

    def __repr__(self):
        return "IE"


class MigrateRequest(Instruction):
    def __repr__(self):
        return "MR"


class EPMigrate(MigrateRequest):
    def __repr__(self):
        return "EPMR"


class PDMigrate(MigrateRequest):
    def __repr__(self):
        return "PDMR"


class PullCache(Instruction):
    """Receiver-side marker: pull the sender's cache blocks (skipped when
    the migration target is the node itself). The receiver's `migrate` sets
    src_node, the node the blocks come from."""

    src_node = None

    def __repr__(self):
        return "PR"


class InstructionList:
    """Doubly-linked list with sentinel head/tail and a cursor."""

    def __init__(self, head: Instruction, tail: Instruction, curr: Instruction):
        self.head = head
        self.tail = tail
        self.curr = curr

    def __iter__(self):
        node = self.head
        while node is not None:
            yield node
            node = node.next

    def __repr__(self):
        parts = []
        for node in self:
            parts.append(("*" if node is self.curr else "") + repr(node))
        return "->".join(parts)

    def __getstate__(self) -> dict:
        """Pickled flat, the links as positions: a list holds a node per
        decode token, and pickling the links themselves recurses once per
        node, past what the pickler allows after a few thousand nodes (the
        process deployment ships requests between processes)."""
        nodes = list(self)
        where = {id(n): i for i, n in enumerate(nodes)}
        flat = []
        for n in nodes:
            attrs = {k: v for k, v in n.__dict__.items() if k not in ("next", "prev")}
            dst = attrs.get("sample_dst")
            at = where.get(id(dst)) if dst is not None else None
            if at is not None:
                del attrs["sample_dst"]
            flat.append((type(n), attrs, at))
        return {"nodes": flat, "curr": where.get(id(self.curr))}

    def __setstate__(self, state: dict) -> None:
        nodes = []
        for cls, attrs, _ in state["nodes"]:
            node = cls.__new__(cls)
            node.__dict__.update(attrs)
            nodes.append(node)
        for node, (_, _, at) in zip(nodes, state["nodes"]):
            if at is not None:
                node.sample_dst = nodes[at]
        for a, b in zip(nodes, nodes[1:]):
            a.next, b.prev = b, a
        self.head, self.tail = nodes[0], nodes[-1]
        self.curr = None if state["curr"] is None else nodes[state["curr"]]


class InstructionListBuilder:
    def __init__(self):
        self.head = EmptyInstruction()
        self.tail = EmptyInstruction()
        self.head.next = self.tail
        self.tail.prev = self.head

    def append(self, inst: Instruction) -> None:
        self.tail.prev.insert_next(inst)

    def build(self) -> InstructionList:
        return InstructionList(self.head, self.tail, self.head.next)
