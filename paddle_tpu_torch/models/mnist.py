"""MNIST models (the port's counterpart of paddle_tpu/models/mnist.py;
reference benchmark/fluid/models/mnist.py and
tests/book/test_recognize_digits.py): the fc net. The conv net needs
conv2d and pool2d, which the port has not yet.
"""
from __future__ import annotations

from .. import layers


def mlp(img, label, hidden_sizes=(128, 64)):
    """784 -> 128 -> 64 -> 10, ReLU between: (mean loss, top-1
    accuracy, logits)."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size, act="relu")
    logits = layers.fc(h, 10)
    loss = layers.softmax_with_cross_entropy(logits, label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(layers.softmax(logits), label)
    return avg_loss, acc, logits


def cnn_model(img, label):
    raise NotImplementedError(
        "the MNIST conv net is not ported yet: it needs the conv2d and "
        "pool2d ops (build_program(use_conv=False) builds the fc net)")


def build_program(batch_size=None, use_conv=True):
    """(main, startup, avg_loss, accuracy), fed img ([B, 784] float32,
    or [B, 1, 28, 28] for the conv net) and label ([B, 1] int64). No
    optimizer: the caller's ``minimize(avg_loss)`` adds it."""
    import paddle_tpu_torch as fluid

    if use_conv:
        cnn_model(None, None)
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = layers.data("img", shape=[784], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        avg_loss, acc, _ = mlp(img, label)
    return main, startup, avg_loss, acc
