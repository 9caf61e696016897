"""CTC training: ``CtcTrainer.train_epoch`` over padded utterance
batches (the program's own upload and prefetch), cycled through the
window.  The traced run drives the parts that ``CtcTrainer.step``
calls: the network, ``ctc_batch_loss``, the backward and the update."""

from __future__ import annotations

import torch

from kaldi_aslp_tpu_torch.data.sequence import CtcBatch
from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
from kaldi_aslp_tpu_torch.train import CtcTrainer
from kaldi_aslp_tpu_torch.train.trainer import upload
from portbench.harness.training import TrainDriver

END_TO_END = "train_audio_s_per_s"


class Driver(TrainDriver):
    trainer_cls = CtcTrainer
    reporter_name = "ctc"
    send = staticmethod(upload)

    @staticmethod
    def to_port(item: dict) -> CtcBatch:
        return CtcBatch([], item["feats"], item["labels"],
                        item["input_lengths"], item["label_lengths"],
                        item["mask"])

    def epoch(self, batches, reporter):
        return self.trainer.train_epoch(self.velocity, batches, self.lr,
                                        reporter)

    def split_step(self, batch, mark) -> None:
        feats, labels, in_lens, lab_lens, mask = batch
        trainer = self.trainer
        mark("forward")
        trainer.net.train()
        for p in trainer.net.parameters():
            p.grad = None
        y, _ = trainer.net(feats, mask=mask, generator=trainer.generator)
        mark("loss")
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens, trainer.blank)
        mark("backward")
        loss.backward()
        mark("update")
        trainer._update(self.velocity, self.lr)

    def context(self, item: dict) -> dict:
        return {"valid_frames": int(item["mask"].sum()),
                "input_lengths": item["input_lengths"],
                "label_lengths": item["label_lengths"]}

    def reference_inputs(self, item: dict) -> dict:
        return {"feats": self._tensor(item["feats"]),
                "mask": self._tensor(item["mask"]),
                "labels": self._tensor(item["labels"], torch.long),
                "input_lengths": self._tensor(item["input_lengths"],
                                              torch.long),
                "label_lengths": self._tensor(item["label_lengths"],
                                              torch.long)}

    def end_to_end(self, stats: dict) -> dict:
        return {END_TO_END: stats["valid_frames"] * self.cfg["frame_shift_s"]
                / stats["seconds"]}
