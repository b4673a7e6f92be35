"""MNIST models (the port's counterpart of paddle_tpu/models/mnist.py;
reference benchmark/fluid/models/mnist.py and
tests/book/test_recognize_digits.py): the fc net and the conv net.
"""
from __future__ import annotations

from .. import layers, nets


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
    """The LeNet-like conv net (reference mnist.py cnn_model): two 5x5
    conv + ReLU + 2x2 max-pool stages of 20 and 50 filters, then fc to
    10: (mean loss, top-1 accuracy, logits)."""
    conv1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    logits = layers.fc(conv2, 10)
    loss = layers.softmax_with_cross_entropy(logits, label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(layers.softmax(logits), label)
    return avg_loss, acc, logits


def build_program(batch_size=None, use_conv=True):
    """(main, startup, avg_loss, accuracy), fed img ([B, 1, 28, 28]
    float32 for the conv net, [B, 784] for the fc net) and label ([B, 1]
    int64). No optimizer: the caller's ``minimize(avg_loss)`` adds it."""
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        if use_conv:
            img = layers.data("img", shape=[1, 28, 28], dtype="float32")
        else:
            img = layers.data("img", shape=[784], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        if use_conv:
            avg_loss, acc, _ = cnn_model(img, label)
        else:
            avg_loss, acc, _ = mlp(img, label)
    return main, startup, avg_loss, acc
