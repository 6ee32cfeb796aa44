#!/usr/bin/env python3
"""ImageNet-scale ResNet-50 training recipe on the port, every scale-out
piece at once (the port's counterpart of ``examples/imagenet_resnet.py``):

- streaming input: a directory of memory-mapped .npy shards
  (``data.FileSource``) behind the native C++ ring of ``data.Pipeline``;
  the dataset never resides in host RAM, and each process prepares only
  its rows of the global batch (``shard=(rank, world)``);
- augmentation on the card: ``nn.RandomCrop`` + ``nn.RandomFlip`` draw
  from the step key inside the train step (a resumed run replays the
  same crops);
- bf16 layers with f32 masters, momentum SGD over a warmup-cosine
  schedule, top-1 and top-5 accuracy;
- sharded checkpoints (``ModelCheckpoint(sharded=True, restore=True)``):
  each process writes its own file, and a relaunch resumes.

One card:
    python3 scripts/torch_imagenet_resnet.py /path/to/shards
Four cards of one host (one worker a card):
    python3 -m distributed_tpu_torch.launch --num-workers 4 \\
        scripts/torch_imagenet_resnet.py /path/to/shards

The shard directory holds ``shard-NNNNN-x.npy`` uint8 images (N, 224, 224,
3) and ``shard-NNNNN-y.npy`` int labels (``data.write_shards`` writes
them).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import distributed_tpu_torch as dtt  # noqa: E402
from distributed_tpu_torch import nn  # noqa: E402

GLOBAL_BATCH = 256
EPOCHS = 90
STEPS_PER_EPOCH = 1_281_167 // GLOBAL_BATCH


def augmented_resnet50(num_classes=1000):
    """Augmentation travels with the model: one step does crop -> flip ->
    ResNet on the card; nothing but the byte copy happens on the host."""
    return nn.Sequential([
        nn.RandomCrop(224, 224, padding=16),
        nn.RandomFlip("horizontal"),
        dtt.models.resnet(50, num_classes, dtype="bfloat16"),
    ], name="augmented_resnet50")


def compile_recipe(model, batch=GLOBAL_BATCH, epochs=EPOCHS,
                   steps_per_epoch=STEPS_PER_EPOCH):
    model.compile(
        optimizer=dtt.optim.sgd_with_cosine(
            0.1 * batch / 256, steps=epochs * steps_per_epoch,
            warmup=5 * steps_per_epoch, momentum=0.9),
        loss="sparse_categorical_crossentropy",
        metrics=["accuracy", dtt.ops.metrics.top_k_accuracy(5)],
    )
    return model


def main(shard_dir: str):
    spec = dtt.cluster.initialize()
    strategy = dtt.DataParallel()
    with strategy.scope():
        model = compile_recipe(dtt.Model(augmented_resnet50()))
    model.build((224, 224, 3))
    pipeline = dtt.data.Pipeline(
        shard_dir,  # FileSource: streams memory-mapped shards
        batch_size=GLOBAL_BATCH,
        shard=(spec.index, spec.num_processes),
        prefetch=8, num_threads=4,
    )
    model.fit(
        pipeline,
        batch_size=GLOBAL_BATCH,
        epochs=EPOCHS,
        steps_per_epoch=min(STEPS_PER_EPOCH, pipeline.steps_per_pass),
        callbacks=[dtt.callbacks.ModelCheckpoint(
            "ckpt/resnet50", save_freq=STEPS_PER_EPOCH, restore=True,
            sharded=True)],
    )
    pipeline.close()
    dtt.cluster.shutdown()


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
