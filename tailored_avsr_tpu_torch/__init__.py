"""tailored_avsr_tpu_torch — the PyTorch/CUDA port of ``tailored_avsr_tpu``.

The JAX package stays the reference; every module here mirrors the JAX
module of the same path and is held against it on the CPU
(``tests/test_torch_port_*.py``). The port covers the flagship tailored
AVSR model's serving: greedy CTC, and the joint CTC/attention beam search
with Transformer-LM fusion over the ancestry KV cache, whose caches and
cross-attention memory may be stored as int8 (``cache_dtype`` /
``mem_dtype: int8``) or the caches in the other float type, and every
other decode choice of the JAX engine: the append
and segmented cache protocols, the time-synchronous CTC beam with
decoder and LM rescoring, n-gram fusion, weight-only quantisation, the
full-prefix LM at ``ctc_weight`` 1.0 and streamed input; its training (hybrid CTC/attention loss, SpecAug,
Adam + Noam, checkpoints, the data path and the CLI); and the same serving
and training for the Branchformer family: the audio-only ASR and
video-only VSR Branchformers, whose learned branch scores
``study_branches`` reads, and the conventional AVSR encoder; and the same
for Mask-CTC (the MLM decoder and its iterative decode, on the tailored
AVSR encoder of ``configs/AVSR/tailored_maskctc_spanish.yaml``) and the
RNN-T transducer (loss, prediction and joint networks, greedy,
multi-blank and ALSD beam decoding, on the ASR Branchformer of
``configs/ASR/branchformer_transducer_spanish.yaml``), so every model
config of ``configs/`` builds, serves and trains; with activation
recomputation (``training_settings remat``) and a config ``init`` scheme;
the other encoders on the Branchformer base (E-Branchformer, Conformer,
Transformer, Longformer, the conventional encoder's Conformer stacks)
with every attention and positional-encoding type, interCTC taps and
conditioning, and the ``word`` / none token types; the other attention
decoders (Sim-T and its Mask-CTC MLM form, the lightweight / dynamic
convolution decoders in 1D and 2D, the LSTM attention decoder, S4),
served by the full-prefix beam with the LM's full-prefix step, and the
RNN / VGG-RNN encoders;
the rest of the paper's recipe: the Transformer-LM trainer and the
analysis scripts, each run with ``python -m``; and data-parallel serving
and data- and tensor-parallel training over ``torch.distributed``, one
process a card (``parallel/``), so the port does everything the JAX
package does:

- ``ops/``     : frontends, MVN, subsampling, positional encodings, rel-pos,
                 absolute and Fastformer attention, cgMLP, FFN, the int8
                 column quantiser (``kv_quant.py``), losses, SpecAug, the
                 RNN-T loss, networks and greedy decoders (``rnnt.py``), plus
                 the wrappers of the hand-written CUDA kernels
                 (``flash_attention.py``, ``fused_csgu.py``,
                 ``group_attend.py``, ``cache_update.py``,
                 ``stream_probe.py``);
- ``models/``  : Conv3D + ResNet-18 visual frontend, AVSR embeddings, the
                 tailored, Branchformer, Conformer, Transformer /
                 Longformer and conventional encoders, adaptive
                 fusion, CTC head, the Transformer, Sim-T, convolution and
                 MLM decoders (``decoder.py``), the LSTM and S4 decoders,
                 the (VGG-)RNN encoder, the Transformer LM, the AVSR and ASR / VSR models and their
                 Mask-CTC variants, activation recomputation (``remat.py``);
- ``tasks/``   : config -> model for the avsr, asr and vsr tasks and the LM,
                 over one registry (``tasks/common.py``);
- ``decode/``  : greedy CTC collapse, CTC prefix scorer, beam search,
                 Mask-CTC, the transducer's ALSD beam, the time-synchronous
                 CTC beam, the n-gram scorer;
- ``inference``: ``Speech2Text`` (``greedy``, ``nbest``, ``__call__``,
                 ``device_put_batch``, ``stream``);
- ``train/``   : optimizer and schedules, train and eval steps (data-
                 parallel over a rank grid), checkpoints;
- ``parallel/``: the rank grid and the tensor-parallel rule, each rank's
                 rows of the global batch, tensor-parallel layers, the
                 multi-rank dry run;
- ``data/``, ``evaluation/``: tokenizers, transforms, dataset and loader;
                 WER / CER;
- ``avsr_main``: the training and inference CLI;
- ``lm_main``  : the Transformer-LM trainer (perplexity, top-K averaging);
- ``study_branches``: the per-layer branch scores of an ASR / VSR model;
- ``study_adaptive_fusion``: the per-utterance adaptive-fusion weights;
- ``average_model``, ``get_val_accs``: checkpoint averaging, by validation
                 statistics or by decoded validation error;
- ``compute_flops``: parameter count and encode FLOPs;
- ``utils/``   : JAX parameters -> port state dict (the port's own copy of
                 the key-grammar export), seeded initialisation and the
                 config ``init`` schemes, weight-only quantisation;
- ``csrc/``    : CUDA C++ sources for ``sm_90a``;
- ``kernels/`` : nvcc build and ctypes bindings.

Conventions follow the JAX package: arrays are ``(B, T, D)``, masks are bool
``(B, T)`` with True = valid frame. Kernels are forward-only: a wrapper runs
its plain PyTorch version for a CPU tensor and launches the CUDA kernel (or
raises) for a CUDA tensor; training mode takes the plain forms. Nothing
here imports JAX.
"""

__version__ = "0.2.0"

