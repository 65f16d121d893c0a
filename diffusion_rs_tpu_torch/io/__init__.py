"""Model I/O: checkpoint containers (safetensors, DDUF, GGUF, legacy GGML),
the VarStore weight registry, key-mapped param builders, tokenizers and file
sources; the names the JAX package's ``io`` exports."""

from .safetensors import SafeTensors  # noqa: F401
from .dduf import DdufFile  # noqa: F401
from .gguf import GgufFile, write_gguf  # noqa: F401
from .ggml import GgmlFile, write_ggml  # noqa: F401
from .varstore import VarStore, VarStoreView  # noqa: F401
from .source import FileLoader, resolve_token  # noqa: F401
from .builders import (  # noqa: F401
    build_clip_params,
    build_flux_params,
    build_t5_params,
    build_vae_params,
)
from ..util.tree import stack_trees  # noqa: F401
from .tokenizer import (  # noqa: F401
    load_clip_bpe_tokenizer,
    load_t5_tokenizer,
    load_t5_tokenizer_from_bytes,
    tokenize_and_pad,
)
