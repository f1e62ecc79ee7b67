# Copyright (c) 2026 touchnet_tpu authors.
# Kimi-Audio's speech-to-text prompts: the inference half of
# touchnet_tpu/models/kimi_audio/processing_kimi_audio.py, copied: the two
# parallel templates (:27-36). The text stream holds the instruct and one
# <|im_kimia_text_blank|> per audio token; the audio stream holds a blank
# per instruct token and the audio tokens between <|im_media_begin|> and
# <|im_media_end|>, where the model merges the speech. The training half
# (dynamic_batch, kimi_audio_datapipe) comes with the kimi_audio SFT slice;
# until then data/dataloader.py raises for datapipe_type kimi_audio.

KIMI_TEXT_TEMPLATE_FOR_S2T = (
    "<|im_kimia_user_msg_start|><|INSTRUCT|><|im_kimia_text_blank|><|AUDIO|>"
    "<|im_kimia_text_blank|><|im_kimia_text_blank|><|im_kimia_text_blank|>"
    "<|im_kimia_text_blank|>"
)
KIMI_AUDIO_TEMPLATE_FOR_S2T = (
    "<|im_kimia_text_blank|><|INSTRUCT|><|im_media_begin|><|AUDIO|>"
    "<|im_media_end|><|im_kimia_speech_ct_id|><|im_msg_end|>"
    "<|im_kimia_assistant_msg_start|>"
)
