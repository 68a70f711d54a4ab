"""The 5-class answer-type label table (``RawPreprocessor.labels2id`` /
``id2labels`` of ``ml_recipe_tpu/data/preprocessor.py``)."""

labels2id = {k: i for i, k in enumerate(["yes", "no", "short", "long", "unknown"])}
id2labels = {i: k for k, i in labels2id.items()}
