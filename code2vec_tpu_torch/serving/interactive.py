"""Prediction results for display: the counterpart of code2vec_tpu/
serving/interactive.py parse_prediction_results and
MethodPredictionResults, plus the interactive loop over a Java file
(InteractivePredictor), which holds one warm extractor worker."""

from __future__ import annotations

from typing import Dict, List

from code2vec_tpu_torch.common import get_subtokens

SHOW_TOP_CONTEXTS = 10


class MethodPredictionResults:
    def __init__(self, original_name: str):
        self.original_name = original_name
        self.predictions: List[dict] = []
        self.attention_paths: List[dict] = []

    def append_prediction(self, name, probability):
        self.predictions.append({"name": name, "probability": probability})

    def append_attention_path(self, attention_score, token1, path, token2):
        self.attention_paths.append({"score": attention_score, "path": path,
                                     "token1": token1, "token2": token2})


def parse_prediction_results(raw_prediction_results,
                             hash_to_string: Dict[str, str], oov_word: str,
                             topk: int = SHOW_TOP_CONTEXTS
                             ) -> List[MethodPredictionResults]:
    out = []
    for raw in raw_prediction_results:
        res = MethodPredictionResults(raw.original_name)
        for i, predicted in enumerate(raw.topk_predicted_words):
            if predicted == oov_word:
                continue
            res.append_prediction(get_subtokens(predicted),
                                  float(raw.topk_predicted_words_scores[i]))
        sorted_contexts = sorted(raw.attention_per_context.items(),
                                 key=lambda kv: kv[1], reverse=True)[:topk]
        for (token1, hashed_path, token2), weight in sorted_contexts:
            if hashed_path in hash_to_string:
                res.append_attention_path(
                    float(weight), token1=token1,
                    path=hash_to_string[hashed_path], token2=token2)
        out.append(res)
    return out


class InteractivePredictor:
    """The REPL over a Java file (reference interactive.py:59-113): ONE
    warm extractor worker (the serving pool at size 1) is held for the
    whole session, so re-predicting after an edit costs a parse, not a
    process spawn; prediction goes through the model's bucketed path."""

    exit_keywords = ("exit", "quit", "q")

    def __init__(self, config, model):
        from code2vec_tpu_torch.serving.extractor_pool import ExtractorPool
        self.model = model
        self.config = config
        self.extractor_pool = ExtractorPool(config, size=1)

    def close(self) -> None:
        self.extractor_pool.close()

    def predict(self, input_filename: str = "Input.java") -> None:
        """Re-predict `input_filename` each time the user presses
        enter."""
        print("Starting interactive prediction...")
        oov = self.model.vocabs.target_vocab.special_words.oov
        try:
            while True:
                print(f'Modify the file: "{input_filename}" and press any '
                      f'key when ready, or "q" / "quit" / "exit" to exit')
                if input().lower() in self.exit_keywords:
                    print("Exiting...")
                    return
                try:
                    lines, hash_to_string = \
                        self.extractor_pool.extract_file(input_filename)
                except (ValueError, FileNotFoundError) as e:
                    print(e)
                    continue
                raw_results = self.model.predict(lines)
                for raw, method in zip(raw_results, parse_prediction_results(
                        raw_results, hash_to_string, oov)):
                    print("Original name:\t" + method.original_name)
                    for pair in method.predictions:
                        print("\t(%f) predicted: %s" % (pair["probability"],
                                                        pair["name"]))
                    print("Attention:")
                    for att in method.attention_paths:
                        print("%f\tcontext: %s,%s,%s" % (
                            att["score"], att["token1"], att["path"],
                            att["token2"]))
                    if (self.config.export_code_vectors
                            and raw.code_vector is not None):
                        print("Code vector:")
                        print(" ".join(map(str, raw.code_vector)))
        finally:
            self.close()
