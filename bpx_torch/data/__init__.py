"""Host-side data pipeline (counterparts in ``bpx/data``): tokenization,
jsonl datasets, feature adapters, static-shape batching, the precollated
cache and prefetching loaders.  Host code (numpy, and ``torch.load`` for
the .pt feature files): nothing here touches a device."""

from bpx_torch.data.vocab import Vocab
from bpx_torch.data.tokenization import WordPieceTokenizer, build_tokenizer
from bpx_torch.data.dataset import JsonlDataset
from bpx_torch.data.loaders import get_data_loaders
