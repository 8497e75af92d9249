"""Structured-prediction layers: linear_chain_crf, crf_decoding,
beam_search and beam_search_decode (counterpart of
``paddle_tpu/fluid/layers/structured.py``; its nce and hsigmoid are
still to come)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["linear_chain_crf", "crf_decoding", "beam_search",
           "beam_search_decode"]


def linear_chain_crf(input, label, param_attr=None, length=None, name=None):
    """CRF negative log-likelihood [B, 1].  input: emissions [B, T, C];
    label: [B, T] int64.  The transition parameter has shape [C+2, C]
    (rows: start, end, transitions)."""
    helper = LayerHelper("linear_chain_crf", name=name)
    c = input.shape[-1]
    transition = helper.create_parameter(param_attr, shape=[c + 2, c],
                                         dtype=input.dtype)
    alpha, em_exps, tr_exps, ll = (
        helper.create_variable_for_type_inference(dtype=input.dtype)
        for _ in range(4))
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("linear_chain_crf", inputs=inputs,
                     outputs={"Alpha": [alpha], "EmissionExps": [em_exps],
                              "TransitionExps": [tr_exps],
                              "LogLikelihood": [ll]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """Viterbi decode with the CRF's transition parameter: pass the
    param_attr (its name) that linear_chain_crf was given."""
    helper = LayerHelper("crf_decoding", name=name)
    attr = ParamAttr._to_attr(param_attr)
    transition = helper.main_program.global_block().var(attr.name)
    path = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None):
    """One step of the dense [B, K] beam (ops/structured_ops.py).
    scores: [B, K, V] log-probs.  Returns (selected_ids, selected_scores,
    parent_idx)."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    sc = helper.create_variable_for_type_inference(dtype=pre_scores.dtype,
                                                   stop_gradient=True)
    parent = helper.create_variable_for_type_inference(dtype="int32",
                                                       stop_gradient=True)
    helper.append_op("beam_search",
                     inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                             "Scores": [scores]},
                     outputs={"SelectedIds": [ids], "SelectedScores": [sc],
                              "ParentIdx": [parent]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, sc, parent


def beam_search_decode(ids, parent_idx, beam_size=None, end_id=0,
                       name=None):
    """Backtrack stacked beam steps (ids, parent_idx: [T, B, K]) into
    sentence ids [B, K, T]."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference(dtype="int64",
                                                     stop_gradient=True)
    scores = helper.create_variable_for_type_inference(dtype="float32",
                                                       stop_gradient=True)
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "ParentIdx": [parent_idx]},
                     outputs={"SentenceIds": [sent],
                              "SentenceScores": [scores]},
                     attrs={"end_id": end_id})
    return sent
