from vqvae_speech_tpu_torch.eval.evaluator import Evaluator

__all__ = ["Evaluator"]
