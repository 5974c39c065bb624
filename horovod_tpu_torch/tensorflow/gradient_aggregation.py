"""Graph-mode local gradient aggregation for TF training loops.

Port of ``horovod_tpu/tensorflow/gradient_aggregation.py`` (reference
parity: horovod/tensorflow/gradient_aggregation.py,
LocalGradientAggregationHelper) — accumulate gradients locally for
``backward_passes_per_step`` passes and allreduce once, halving (or
better) the communication frequency.  State lives in ``tf.Variable``s so
the whole schedule traces into a ``tf.function`` (the Keras-3 optimizer
wrapper's eager aggregation cannot); the apply itself is gated by
``tf.cond`` exactly like the reference.

Usage in a custom loop::

    agg = LocalGradientAggregationHelper(
        backward_passes_per_step=4,
        allreduce_func=lambda gs: [hvd.allreduce(g, op=hvd.Average)
                                   for g in gs],
    )

    @tf.function
    def train_step(x, y):
        with tf.GradientTape() as tape:
            loss = loss_fn(model(x), y)
        grads = tape.gradient(loss, model.trainable_variables)
        grads = agg.compute_gradients(grads)       # zeros on skip passes
        agg.apply_gradients(
            lambda: opt.apply_gradients(
                zip(grads, model.trainable_variables)
            )
        )
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import tensorflow as tf


class LocalGradientAggregationHelper:
    """Reference: horovod/tensorflow LocalGradientAggregationHelper."""

    def __init__(
        self,
        backward_passes_per_step: int,
        allreduce_func: Callable[[List[tf.Tensor]], List[tf.Tensor]],
        average_aggregated_gradients: bool = True,
    ):
        if backward_passes_per_step <= 0:
            raise ValueError("backward_passes_per_step must be > 0")
        self.backward_passes_per_step = backward_passes_per_step
        self.average_aggregated_gradients = average_aggregated_gradients
        self._allreduce = allreduce_func
        self._counter: Optional[tf.Variable] = None
        self._buffers: List[tf.Variable] = []

    def _build(self, grads: Sequence[tf.Tensor]) -> None:
        self._counter = tf.Variable(0, dtype=tf.int32, trainable=False,
                                    name="hvd_agg_counter")
        self._buffers = [
            tf.Variable(tf.zeros_like(g), trainable=False,
                        name=f"hvd_agg_buf_{i}")
            for i, g in enumerate(grads)
        ]

    def compute_gradients(self, grads: Sequence[tf.Tensor]):
        """Accumulate; on the Nth pass return the allreduced aggregate
        (and reset), otherwise return zeros (the paired
        ``apply_gradients`` no-ops on those passes)."""
        grads = list(grads)
        if any(g is None for g in grads):
            raise ValueError(
                "LocalGradientAggregationHelper requires materialized "
                "gradients (got None); filter variables without gradients"
            )
        if self._counter is None:
            self._build(grads)
        for buf, g in zip(self._buffers, grads):
            buf.assign_add(g)
        self._counter.assign_add(1)
        n = self.backward_passes_per_step

        def flush():
            aggregated = [tf.identity(b) for b in self._buffers]
            if self.average_aggregated_gradients:
                aggregated = [a / n for a in aggregated]
            reduced = self._allreduce(aggregated)
            for b in self._buffers:
                b.assign(tf.zeros_like(b))
            self._counter.assign(0)
            return list(reduced)

        def skip():
            return [tf.zeros_like(b) for b in self._buffers]

        return tf.cond(tf.equal(self._counter, n), flush, skip)

    def apply_gradients(self, apply_closure: Callable[[], None]) -> None:
        """Run ``apply_closure`` only on flush passes (reference:
        the helper's tf.cond-wrapped apply)."""
        if self._counter is None:
            raise RuntimeError("call compute_gradients first")

        def do():
            apply_closure()
            return tf.constant(0)

        # both branches must return the same structure under tf.cond
        tf.cond(tf.equal(self._counter, 0),  # flush just reset it
                do, lambda: tf.constant(0))
