"""The data stack, the port's copy of `hetu_tpu/data` (host-only numpy
and Python; the embedding cache arrives with the control-plane slice):
bucketing, padding and packing (`bucket`), the LM collator, the
prefetching loader, datasets, SFT message templates and the tokenizers.
The names are the reference's."""
from hetu_tpu_torch.data.bucket import (Bucket, pad_batch, pack_sequences,
                                        cp_split_batch, cp_split_uneven,
                                        merge_cp_uneven)
from hetu_tpu_torch.data.dataset import JsonDataset, TokenizedDataset
from hetu_tpu_torch.data.dataloader import DataLoader, build_data_loader
from hetu_tpu_torch.data.data_collator import DataCollatorForLanguageModel
from hetu_tpu_torch.data.messages import (AlpacaTemplate, ChatFormat,
                                          InputOutputTemplate, OpenAITemplate,
                                          ShareGPTTemplate, build_sft_example,
                                          render_messages)
