"""The hard-copy demo of the port (counterparts of
``scripts/pretrain_hard_encoder.py``, ``scripts/pretrain_copy_generator.py``
and ``docs/demo/e2e_hard_copy_task.py``): a small dual encoder trained by
in-batch InfoNCE, a small llama generator copy-pretrained on gold passages,
and the joint rag fine-tune over an index they build, on the data of
``scripts/make_copy_task_data.py --hard``::

    python scripts/make_copy_task_data.py --out data/hardcopy --hard \\
        --n_topics 4000 --n_train_topics 3000 --n_eval 200 \\
        --train_per_topic 4
    python -m jsa_rag_tpu_torch.demo.pretrain_hard_encoder \\
        --data data/hardcopy --out out/hard_encoder.pkl --steps 500
    python -m jsa_rag_tpu_torch.demo.pretrain_copy_generator \\
        --data data/hardcopy --encoder out/hard_encoder.pkl \\
        --out out/hard_generator.pkl --steps 2500 --checkpoint_dir out/ck
    python -m jsa_rag_tpu_torch.demo.e2e_hard_copy --data data/hardcopy \\
        --encoder out/hard_encoder.pkl --generator out/hard_generator.pkl \\
        --out out/metrics-e2e-hard.jsonl --checkpoint_dir out/ck

The artifacts are the JAX scripts' pickles, key for key, so either package
reads the other's.

The copy task (counterparts of ``docs/demo/e2e_copy_task.py``,
``docs/demo/jsa_mechanism_demo.py`` and ``docs/demo/hf_interop_drive.py``;
``scripts/make_copy_task_data.py`` without ``--hard``): ``copy_task``
copy-pretrains the generator through the train entry and holds the setup
both demos share, ``e2e_copy`` runs zero shot and joint rag training,
``jsa_mechanism`` the JSA mechanism probe, and ``hf_interop`` drives the
HF directories through training, evaluation and the Atlas round trip::

    python -m jsa_rag_tpu_torch.demo.copy_task --data data/copy \
        --checkpoint_dir out/ck     # the data: copy_task.make_data
    python -m jsa_rag_tpu_torch.demo.e2e_copy --data data/copy \
        --generator out/ck/copy-generator --checkpoint_dir out/ck \
        --out out/metrics-e2e-copy.jsonl
    python -m jsa_rag_tpu_torch.demo.jsa_mechanism --data data/copy \
        --generator out/ck/copy-generator --checkpoint_dir out/ck \
        --out out/metrics-jsa-mechanism.jsonl
    python -m jsa_rag_tpu_torch.demo.hf_interop --work out/hf \
        --out out/transcript-hf-interop.md

Every module runs on ``--device`` (default ``cuda``, which raises where
there is none).
"""

import json


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def passage_text(p: dict) -> str:
    return f"{p['title']} {p['text']}"
