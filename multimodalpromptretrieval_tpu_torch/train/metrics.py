"""Test-time metric suite — exact reference definitions (main.py:229-363).

A copy of ``multimodalpromptretrieval_tpu/train/metrics.py`` (the port
shares no module with the JAX package): the same report text and artifact
files for the same predictions.

  * exact-match accuracy with the fuzzy string-match credit: a prediction
    also counts when the difflib-closest test answer's label equals the gold
    label even if the generated string differs (main.py:296-307, quirk #13);
  * per-question-type (task), open/closed, and overall accuracies;
  * seven retrieval-reliance diagnostics over the retrieved answer lists
    (main.py:339-346);
  * the same artifact files: logs/{incorrect_ids,correct_ids}.txt and
    logs/<prefix>performance.txt with the reference's exact formatting.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class TestMetrics:
    def __init__(self, retrieval_k: Optional[int] = None):
        self.correct: Dict[str, int] = defaultdict(int)
        self.total: Dict[str, int] = defaultdict(int)
        self.open_correct = 0
        self.closed_correct = 0
        self.open_total = 0
        self.closed_total = 0
        self.string_match_correct = 0
        self.correct_ids: List[str] = []
        self.incorrect_ids: List[str] = []
        # retrieval diagnostics
        self.k = retrieval_k
        self.consistencies: List[float] = []
        self.ground_truth_consistency: List[float] = []
        self.question_type_consistencies: List[float] = []
        self.pred_in_retrieval = 0
        self.ground_truth_in_retrieval = 0
        self.full_retrieval_reliance_pred = 0
        self.full_retrieval_reliance_gt = 0
        self.correct_by_retrieved_dist: Dict[float, int] = {}
        self.total_by_retrieved_dist: Dict[float, int] = {}
        # raw per-entry predictions in evaluation order, keyed like the
        # VQA-RAD fan-out requires: (question_id, task) -> answer string
        # (generative) or class id (classification). Not a reference
        # artifact — used by tests to pin serve answers to test() output
        # and handy for error analysis.
        self.predictions: Dict[tuple, object] = {}

    # -- per-example updates --------------------------------------------------

    def add_generative(self, pred_answer: str, entry: dict,
                       closest_label: Optional[int]) -> bool:
        """closest_label = dataset.get_closest_label(pred.lower()) or None
        when the fuzzy credit is disabled. Returns is_correct."""
        string_matched = False
        if closest_label is not None and closest_label == entry["label"]:
            self.string_match_correct += 1
            if pred_answer.lower() != entry["answer"].lower():
                string_matched = True
        is_correct = (pred_answer.lower() == entry["answer"].lower()
                      or string_matched)
        self.predictions[(entry["question_id"], entry["task"])] = pred_answer
        self._tally(is_correct, entry)
        return is_correct

    def add_classification(self, pred_label: int, entry: dict) -> bool:
        is_correct = pred_label == entry["label"]
        self.predictions[(entry["question_id"], entry["task"])] = pred_label
        self._tally(is_correct, entry)
        return is_correct

    def _tally(self, is_correct: bool, entry: dict) -> None:
        if is_correct:
            self.correct_ids.append(entry["question_id"])
            self.correct[entry["task"]] += 1
            if entry["question_type"] == "open":
                self.open_correct += 1
            else:
                self.closed_correct += 1
        else:
            self.incorrect_ids.append(entry["question_id"])
        self.total[entry["task"]] += 1
        if entry["question_type"] == "open":
            self.open_total += 1
        else:
            self.closed_total += 1

    def add_retrieval_diagnostics(
        self, pred_answer: str, entry: dict,
        retrieved_answers: Sequence[str],
        retrieved_answer_types: Sequence[str],
    ) -> None:
        """main.py:266-294 — per-example retrieval consistency stats."""
        ra = list(retrieved_answers)
        pred = pred_answer.lower()
        gt = entry["answer"].lower()
        self.consistencies.append(sum(1 for x in ra if x == pred) / len(ra))
        self.ground_truth_consistency.append(
            sum(1 for x in ra if x == gt) / len(ra))
        self.question_type_consistencies.append(
            sum(1 for x in retrieved_answer_types
                if x == entry["question_type"]) / len(retrieved_answer_types))
        # The reference picks max(set(...), key=list.count) (main.py:283)
        # — but set iteration order is PYTHONHASHSEED-randomized, so on
        # count ties the reported percentages differ per process. Break
        # ties by first retrieval rank instead (the same rule the prompt
        # vote uses, retrieval/index.majority_vote): one valid resolution
        # of the reference's unspecified tie order, and process-stable.
        most_freq = max(dict.fromkeys(ra), key=ra.count)
        proportion = ra.count(most_freq) / (self.k or len(ra))
        self.total_by_retrieved_dist[proportion] = \
            self.total_by_retrieved_dist.get(proportion, 0) + 1
        if pred == gt:
            self.correct_by_retrieved_dist[proportion] = \
                self.correct_by_retrieved_dist.get(proportion, 0) + 1
        if gt in ra:
            self.ground_truth_in_retrieval += 1
        if pred in ra:
            self.pred_in_retrieval += 1
        if gt == most_freq:
            self.full_retrieval_reliance_gt += 1
        if pred == most_freq:
            self.full_retrieval_reliance_pred += 1

    # -- reports --------------------------------------------------------------

    @property
    def performance(self) -> Dict[str, float]:
        return {k: self.correct[k] / self.total[k] for k in self.correct}

    @property
    def overall(self) -> float:
        return sum(self.correct.values()) / max(sum(self.total.values()), 1)

    def report(self) -> str:
        lines = ["=======QUESTION TYPE PERFORMANCE======="]
        perf = self.performance
        for key in sorted(perf):
            lines.append(f"{key}: {100 * perf[key]:.1f}")
        lines.append("=======OPEN VS CLOSED PERFORMANCE======")
        if self.open_total:
            lines.append(f"Open: {100 * self.open_correct / self.open_total:.1f}")
        if self.closed_total:
            lines.append(
                f"Closed: {100 * self.closed_correct / self.closed_total:.1f}")
        lines.append("===========OVERALL PERFORMANCE=========")
        lines.append(f"Overall accuracy: {100 * self.overall:.1f}")
        if self.consistencies:
            n = len(self.consistencies)
            lines.append(
                "Percentage of retrieved answers which == model prediction: "
                f"{100 * sum(self.consistencies) / n:.1f}")
            lines.append(
                "Percentage of retrieved answers which == ground truth: "
                f"{100 * sum(self.ground_truth_consistency) / n:.1f}")
            lines.append(
                "Percentage of retrieved answers which have correct answer "
                f"type: {100 * sum(self.question_type_consistencies) / n:.1f}")
            lines.append(
                "How often prediction is contained within set of retreieved "
                f"answers: {100 * self.pred_in_retrieval / n:.1f}")
            lines.append(
                "How often ground truth is contained within set of retrieved "
                f"answers: {100 * self.ground_truth_in_retrieval / n:.1f}")
            lines.append(
                "How often ground truth == most common retrieved answer: "
                f"{100 * self.full_retrieval_reliance_gt / n:.1f}")
            lines.append(
                "How often prediction == most common retrieved answer: "
                f"{100 * self.full_retrieval_reliance_pred / n:.1f}")
        return "\n".join(lines)

    def write_artifacts(self, log_dir: str, model_prefix: str) -> None:
        """logs/{incorrect_ids,correct_ids}.txt + <prefix>performance.txt
        with the reference's exact line formats (main.py:348-363)."""
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "incorrect_ids.txt"), "w") as f:
            for qid in self.incorrect_ids:
                f.write(str(qid) + "\n")
        with open(os.path.join(log_dir, "correct_ids.txt"), "w") as f:
            for qid in self.correct_ids:
                f.write(str(qid) + "\n")
        perf = self.performance
        with open(os.path.join(log_dir, model_prefix + "performance.txt"),
                  "w") as f:
            for key in sorted(perf):
                f.write(f"{100 * perf[key]:.1f}\n")
            f.write(f"Open,{self.open_correct / max(self.open_total, 1):.4f}\n")
            f.write(
                f"Closed: {self.closed_correct / max(self.closed_total, 1):.4f}\n")
            f.write(f"Overall,{self.overall:.4f}")
