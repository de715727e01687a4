"""Evaluation metrics (parity: mxnet_tpu/metric.py EvalMetric, Accuracy,
CrossEntropy, create).  Metrics read predictions back to the host."""
from __future__ import annotations

import numpy

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "CrossEntropy", "create"]


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("{} labels do not match {} predictions"
                         .format(len(labels), len(preds)))


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """Base metric (parity: metric.py EvalMetric)."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]


class Accuracy(EvalMetric):
    """Classification accuracy (parity: metric.py Accuracy)."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_np = _host(pred_label)
            label_np = _host(label)
            if pred_np.shape != label_np.shape:
                pred_np = numpy.argmax(pred_np, axis=self.axis)
            label_np = label_np.astype("int32")
            pred_np = pred_np.astype("int32")
            check_label_shapes(label_np.flat, pred_np.flat)
            self.sum_metric += (pred_np.flat == label_np.flat).sum()
            self.num_inst += len(pred_np.flat)


class CrossEntropy(EvalMetric):
    """Cross entropy of softmax output vs int labels (parity: metric.py CrossEntropy)."""

    def __init__(self, eps=1e-8, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label_np = _host(label).ravel()
            pred_np = _host(pred)
            if label_np.shape[0] != pred_np.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d predictions"
                                 % (label_np.shape[0], pred_np.shape[0]))
            prob = pred_np[numpy.arange(label_np.shape[0]), numpy.int64(label_np)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label_np.shape[0]


def create(metric, **kwargs):
    """Create a metric by name, or pass an EvalMetric through (parity: metric.py create)."""
    if isinstance(metric, EvalMetric):
        return metric
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "cross-entropy": CrossEntropy, "crossentropy": CrossEntropy}
    try:
        return metrics[metric.lower()](**kwargs)
    except (KeyError, AttributeError):
        raise ValueError("Metric must be an EvalMetric or one of {}"
                         .format(sorted(metrics.keys())))
