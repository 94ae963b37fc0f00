"""Quickstart — the engine-native and analiticcl-compatible APIs.

Covers the same ground as the reference's tutorial notebook: building a model
from lexicons, querying variants, searching running text with a language
model, learning variants from a corpus, and checkpointing.

Run from the repository root:  python examples/quickstart.py
"""

import sys

sys.path.insert(0, ".")

ALPHABET = "/root/reference/examples/simple.alphabet.tsv"
LEXICON = "/root/reference/examples/eng.aspell.lexicon"


def compat_api():
    """analiticcl-compatible surface: swap `import analiticcl` for this."""
    from analiticcl_jax.api import SearchParameters, VariantModel, Weights

    model = VariantModel(ALPHABET, Weights(), debug=0)
    model.read_lexicon(LEXICON)
    model.build()

    params = SearchParameters(max_edit_distance=2, max_anagram_distance=3)
    print(model.find_variants("seperate", params)[:3])
    print(model.find_variants_par(["theere", "recieve"], params)[0]["variants"][:2])
    print(model.find_all_matches("I beleive this is rihgt", params)[1]["variants"][:1])


def engine_api():
    """Engine-native surface: batching, meshes, checkpoints."""
    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.types import DistanceThreshold, SearchParameters
    from analiticcl_jax.vocab import VocabParams

    model = VariantModel(alphabet_file=ALPHABET)
    model.read_vocabulary(LEXICON, VocabParams())
    model.build()

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=5,
    )

    # batched queries (one fused device call per batch)
    results = model.find_variants_batch(["theere", "seperate", "recieve"], params)
    for query, res in zip(["theere", "seperate", "recieve"], results):
        best = model.decoder[res[0].vocab_id].text if res else None
        print(f"{query} -> {best}")

    # learn variants from a corpus, then checkpoint
    model.learn_variants(["theere", "theere", "recieve"], params, strict=True)
    model.save("/tmp/quickstart_model.npz")
    restored = VariantModel.load("/tmp/quickstart_model.npz")
    print("restored:", len(restored.decoder), "vocabulary entries")

    # shard over every visible device (dp x lex mesh)
    import jax

    if len(jax.devices()) > 1:
        model.use_mesh(dp=1)
        print(model.find_variants_batch(["theere"], params)[0][:1])


if __name__ == "__main__":
    compat_api()
    engine_api()
